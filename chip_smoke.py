"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

From the root of a checkout: builds the port's CUDA kernels from
`csm_mlx_tpu_torch/csrc/` and holds each against its plain PyTorch version
at the shapes of the main path — the W8A8 matvec (decode rows, and prefill
rows above 64 on its int8 tensor-core GEMM route, timed beside
`torch._int_mm`) and flash prefill (S = 256, 512, 2048, pads inside,
across and past the first 64-row tile, a bit-equal repeat, timed beside
SDPA) on random inputs, the whole-frame decoder (kernel 3) on the
full-width CSM-1B decoder at B = 1, 8, 16, 32 and 64 (greedy,
teacher-forced agreement, its phase split from its own records and its
streaming floor) and at T = 0.8 (a
chi-square of its codebook-1 picks) — then checks the main path
on the card against the CPU on a small model, and drives the main path at
full CSM-1B width: random weights from a seed, W8A8, greedy
`generate_tokens` for 125 frames (10 s of audio) from a 32-row prompt and
10 frames from a 300-row prompt that takes the flash-prefill kernel, each
decoder frame one kernel-3 launch, and a Mimi decode to a waveform. It
checks that every kernel ran in it, times one prefill of a 300- and a
1100-row prompt through kernel 2 and through the masked sdpa, alternated,
then drives the dispatched decoder for
10 frames (tables removed) and compares it with kernel 3 by teacher-forced
flips per margin bin, and runs a 65-prompt batch (two kernel-3 chunks a
frame).

Every generation phase runs its frames after the first through the
captured frame step (`generation.FrameStep`: one CUDA graph a frame, kernel
3's cooperative launch inside it) and, where it says so, through the eager
step too (`_eager_step`), alternated: the main path's 125 frames, the
dispatched decoder, the 65-prompt batch and the affine 4-bit path must
give the same greedy frames both ways, with ms a frame and, from the
profiler, device events and busy ms a frame of each. `stream_generate`
streams 125 frames with the full Mimi step in the graph, its chunks held
to the batch decode of the same frames, and times the first chunk and the
gaps of short streams, captured and eager alternated; a T = 0.8 run
through the graph shows that each replay draws new kernel-3 seeds and c0.
A replay counts the launches its graph holds, so the launch counts include
the replayed frames.

Voice-prompted generation (context audio): the full-width Mimi encoder on
a 10 s test waveform (tones under an envelope, low noise, from numpy) on
the card against the same parameters on the CPU — the latent before the
RVQ, and the codes, where every first difference of a codebook chain must
be a near tie — and `encode_step` frame by frame against the batch
encode, with their times and, as a finding, the code agreement under
cuDNN's TF32 convs; then CSM-1B W8A8 with two context segments (10 s and
8 s): a prompt of >= 256 rows (bucket 512) through `generate_tokens`
(kernel 1's GEMM route and kernel 2 in the prefill, kernel 3 a frame),
captured and eager alternated, the prefill's device ms,
`stream_generate(context=...)` held to the batch decode with its first
chunk timed, and `generate_batch` of 4 rows with 0, 1, 2 and 2 context
segments.

Serving: the continuous engine (`continuous.ContinuousEngine`) at its
defaults, 64 slots and blocks of K = 8 frames, each block one replayed
CUDA graph per KV bucket, on CSM-1B W8A8 with Mimi(32): two context
requests (a 512-row prompt bucket: kernel 2 and kernel 1's GEMM route in
their admission) and 96 32-row requests of 10-60 frames, 64 admitted at
once and the rest as slots free, then 8 short ones (a bucket grow, an
eager rebase and a shrink): frames a second, the aggregate RTF, the first
chunk's p50 and p90, kernel 3 exactly once a frame stepped, kernel 4 (the
engine's default) once a layer a backbone step; a first-wave request's
chunks against the batch decode; 8 requests against their solo
`generate_tokens` runs (each first difference a near tie of the layout's
noise and kernel 4's, the requests replayed through kernel 4 in every
step); kernel 4 against its plain version on the engine's cache as a
bucket's graph reads it (a prefix view, the engine's pads), and unmoved
with every key and value outside a row's valid range overwritten;
captured blocks against eager ones
(equal frames and chunks), a block's device time by part (the engine's
own eager block, with its timing marks), the PCM16 transfer, T = 0.8 (new
draws each replay) and kernel 4 (`flash_decode_min_b=8`) on and off,
alternated, with ms a block and its frames against the engine's without
it (equal or a near tie); then both servers, as the `serve` CLI's flags
make them, through `serve_http` (POST /tts, POST /tts-stream against it,
GET /stats, a 503 past --max-pending) and `--watermark-key` on one
request through each, the mark detected on the card and on the CPU.

The user entry points: the int8 audio head (`quantize_model` with
"audio_head" among its targets: 31 heads padded to 2,176 rows, the
dispatched decoder) — kernel 1 on a head at 1 and 64 rows against its
plain version, timed over the 31 heads with its bound and
`torch._int_mm` over the same heads, 20 frames captured against eager,
one kernel-1 launch a codebook, and replayed frames of the raw and the
int8 head timed alternately; the CLI's `generate` run end to end on a
saved bf16 CSM-1B checkpoint (flags through `build_parser()`, the WAV
equal to a direct `generate` call's on the checkpoint loaded again),
`finetune convert` of two `smoke_wave` turns and one `finetune lora sft`
step on that model whose adapters reload to the trained model's logits;
then CSM-1B W4A8 (4-bit codes in int8 carriers, kernel 3's tables):
kernel 1 on its codes at 1, 64 and 300 rows, kernel 3 bit-equal to its
plain version at B = 1 and 64, each with the bound of packed 4-bit
codes beside the carriers', and the main path's 125 frames captured
against eager, each beside its W8A8 time.

The voice chat (`apps/voice_chat.py`) on the W8A8 CSM-1B with Mimi(32):
a `VoiceChatPipeline` fed from numpy through `NullAudioIO`, a scripted
STT and streaming LLM, `build_tts_stream_fn` with the app's sampler (T
0.6, top-k 50, min-p 0.05): three turns of three 35-frame sentences (the
context fills and rolls at 6 segments, the prompts pass 256 rows: kernel
1's GEMM route and kernel 2) and a turn interrupted while the bot speaks,
each turn's voice-to-voice latency and each sentence's first chunk,
context rows and prompt-assembly ms (gates: the session WAV is the played
chunks, kernel 3 once a frame, no TTS failure or timeout logged, the
barge-in fades within FADE_CHUNKS and drops the reply's other sentences),
then one turn on CSM-1B affine 4-bit g64 (kernel 5 alone); a trace by
`utils.profiling.trace` of 4 replayed frames in one `annotate` span (it
names kernels 1 and 3 and the span); the int8 codec
(`models/mimi/quant.py` on a copy of Mimi(32)): the 125 frames decoded
int8 against fp32 and streamed against batched within JAX's bounds, each
int8 conv's int32 sums (one `torch._int_mm`) bit-equal to the plain
version on the CPU and timed against the fp32 conv, kernel 1 on the codec
transformer's linears, the engine with `quantize_codec` on and off
alternated (ms a block, the Mimi part of its eager block) and `serve
--continuous --quantize-codec` through `make_server`.

Then the MLX-affine and batch flash-decode paths: kernel 5 (the
grouped-affine matvec) against its plain version at the quantized
linears' shapes, 4- and 8-bit, group 64 (and 128), B = 1, 2, 8, 16, 32,
64, rows bit-equal across B and repeats, timed beside dequant +
`torch.matmul` and `torch._weight_int4pack_mm` at B = 1, 8, 64, with its
device time summed over one affine frame and over the 32-row prefill;
kernel 4 (flash decode, the cache split over blocks and merged in split
order) against its plain version at H=32/8, D=64 over several (B, cap)
and the split edges, with bit-equal repeats, timed beside
`scaled_dot_product_attention` and split by launch; a small
affine model card-vs-CPU; 64 prompts through `generate_tokens_batch` with
`flash_decode_min_b=8` (16 kernel-4 launches a backbone step) and without,
alternated, the same at 8 prompts and one prompt through `generate_tokens`
with `flash_decode_min_b=1`, and one step on the same cache both ways on
an unquantized CSM-1B in bf16 and fp32; CSM-1B affine 4-bit group 64 for
20 frames (kernel 5 on every quantized linear, kernels 1 and 3 never) with
a Mimi decode, and 8-bit for 5.

Then the fine-tuning path: kernels 6 and 7 (causal flash attention forward
and backward) against their plain versions at the backbone's shape, (B=2,
S=575) and (B=1, S=2048) in fp32 and bf16, timed beside the library's
`scaled_dot_product_attention`; CSM-1B at full width and depth in bf16
trained on synthetic (B=2, S=576) batches — full SFT with remat, a DPO and
a KTO step, LoRA rank 8, `train()` with checkpoints and a resume — with
the kernels' launch counts per step; full SFT with
`checkpoint_backend="orbax"` (asynchronous saves, each step after the
first with a save in flight, then a synchronous one) and its resume
(gate: weights and optimizer state bit-equal); and one training step
through the kernels against the masked sdpa on a 2-layer full-width
backbone.

Then parallel fine-tuning (`csm_mlx_tpu_torch/parallel/`, the trainers'
`mesh`), CSM-1B bf16 full SFT at (B=2, S=576): (a) one NCCL rank in this
process, replicated and FSDP steps bit-equal to the mesh-less trainer's,
with their ms, peaks, stored bytes and kernels 6 and 7 launches; a probe
of gloo's point-to-point sends on CUDA tensors (two processes), and, as
gloo cannot carry them, ring attention at (1, 32, 2048, 64) fp32 and bf16
(forward and backward against the plain causal attention) and the
16-layer backbone pipeline (against `llama_forward`) on the NCCL rank;
(b) two ranks spawned on the one card over gloo, loading the kernels
built here: replicated and FSDP steps against the one-process steps, the
bytes each rank stores for parameters and AdamW state, and gloo's
all-reduce and all-gather times.

Last, sharded serving (`parallel.shard_model` + `mesh=`, CSM-1B at full
width, the dispatched decoder): kernel 1's three in-sharded entries
(quantized rows, int32 partials, fix-up) against their plain versions at
the o_proj and down_proj shards of a model axis of 2, timed beside the
fused kernel; (a) one NCCL rank on a {data: 1, model: 1} mesh, W8A8:
`generate_tokens` from a 32- and a 300-row prompt, captured, and the
engine at 16 slots with kernel 4, each equal to its mesh-less run, with
the collectives each graph's capture recorded and the profiler's view of
a replay; (b) two gloo ranks on the one card, eager: {model: 2} bf16 and
W8A8 batches against a one-process run, kernel 1's partials summed
against the solo int32 sums, and the engine on {data: 2}. Any failure
raises; the last line of standard output is then missing.

Prints the card's name and power limit, one line per check and phase, the
kernels' line `{"kernels": [...]}` (times measured here, bounds computed
from this run's shapes against the H100's published peaks) and, last,
`{"ok": true, "device": {...}}`. Needs one CUDA device; exits nonzero
without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace as dataclass_replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from csm_mlx_tpu_torch import config as port_config  # noqa: E402
from csm_mlx_tpu_torch import parallel  # noqa: E402
from csm_mlx_tpu_torch import generation  # noqa: E402
from csm_mlx_tpu_torch.finetune import lora  # noqa: E402
from csm_mlx_tpu_torch.finetune import trainer as ft  # noqa: E402
from csm_mlx_tpu_torch.finetune.dataset import CSMDataset  # noqa: E402
from csm_mlx_tpu_torch.finetune.loss import compute_loss  # noqa: E402
from csm_mlx_tpu_torch.generation import (generate_tokens,  # noqa: E402
                                          generate_tokens_batch)
from csm_mlx_tpu_torch.loaders import tree_to_flat  # noqa: E402
from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs, csm_1b  # noqa: E402
from csm_mlx_tpu_torch.models.csm import embed_audio  # noqa: E402
from csm_mlx_tpu_torch.models.mimi import Mimi, mimi_202407  # noqa: E402
from csm_mlx_tpu_torch.models.mimi import mimi as mimi_module  # noqa: E402
from csm_mlx_tpu_torch.models.llama import llama_forward  # noqa: E402
from csm_mlx_tpu_torch.models.mimi.rvq import codebook_embed  # noqa: E402
from csm_mlx_tpu_torch.ops import _build  # noqa: E402
from csm_mlx_tpu_torch.ops import attention, quant  # noqa: E402
from csm_mlx_tpu_torch.ops import flash_train  # noqa: E402
from csm_mlx_tpu_torch.ops import launches as launch_registry  # noqa: E402
from csm_mlx_tpu_torch.ops import resident_decoder as resident  # noqa: E402
from csm_mlx_tpu_torch.ops.kv_cache import KVCache  # noqa: E402
from csm_mlx_tpu_torch.ops.layers import linear, rms_norm  # noqa: E402
from csm_mlx_tpu_torch.ops.rope import rope_cache_for  # noqa: E402
from csm_mlx_tpu_torch.ops.sampling import SamplerConfig  # noqa: E402

SEED = 0
W8A8_SHAPES = {  # (IN, OUT) of the main path's quantized linears
    "backbone qkv": (2048, 3072),
    "backbone gate-up": (2048, 16384),
    "backbone down": (8192, 2048),
    "decoder qkv": (1024, 1536),
    "projection": (2048, 1024),
}
# decode batches (the matvec), and prefill rows (the tensor-core GEMM above
# 64 rows: 65 its lower edge, 300 and 2048 ragged and full tiles, 512 the
# recorded case)
W8A8_ROWS = (1, 8, 64, 65, 300, 512, 2048)
# the gate-up before the GEMM route (PERF.md §6), H100 80GB HBM3, 700 W
W8A8_RECORDED_US = {1: 17.45, 512: 1045.0}
# Kernel 2 (flash prefill), B=2, H=32, n_kv=8, D=64: S of the 256-, 512-
# and 2048-row prompt buckets; the left pads of the two rows: none, inside
# the first 64-row tile, inside a later tile (200: q tile 3 straddles it),
# a whole first tile (64) and pads past it on both rows. Timed at
# FLASH_TIMED_PADS.
FLASH_CASES = [(s, dtype) for s in (256, 512, 2048)
               for dtype in (torch.bfloat16, torch.float32)]
FLASH_PADS = ((0, 0), (0, 37), (0, 200), (64, 100), (130, 255))
FLASH_TIMED_PADS = (0, 200)
# The first cases of kernels 2 and 4 draw their inputs from the phase's
# generator, in their first order, so that every later phase keeps the
# inputs it had before the other cases came; those draw from a generator
# of their own.
FLASH_EARLIER_PADS = ((0, 0), (0, 37), (0, 200))
COLD_BYTES = 160 << 20  # weights cycled per timing run, > the 50 MB L2
RESIDENT_ROWS = (1, 8, 16, 32, 64)
# rows whose inputs come from a generator of their own (16 and 32 came with
# the spread per-row phases), so that later phases keep their inputs
RESIDENT_NEW_ROWS = (16, 32)
# Kernel 3 before its redesign (per-row phases on one block a row, dp4a
# matvecs; PERF.md §6) on an NVIDIA H100 80GB HBM3 at 700 W: ms of one
# frame, and its phase split by kind (ms of the frame, from the kernel's
# phase records), printed beside this run's
RESIDENT_RECORDED_MS = {1: 7.649, 8: 16.58, 64: 76.11}
RESIDENT_RECORDED_SPLIT = {
    1: {"attention": 3.4706, "barrier": 1.0995, "gate-up": 1.0793,
        "prep": 0.9375, "down": 0.7452, "qkv": 0.3064, "o": 0.2616,
        "pick": 0.1426, "head": 0.0801},
    8: {"down": 4.2926, "gate-up": 3.9818, "attention": 3.6716,
        "prep": 1.2864, "barrier": 1.0593, "qkv": 1.0440, "o": 0.9021,
        "head": 0.5432, "pick": 0.2422},
    64: {"down": 31.4772, "gate-up": 24.4608, "qkv": 6.4136, "o": 6.1105,
         "attention": 3.8175, "head": 2.4704, "prep": 1.4845,
         "barrier": 1.0493, "pick": 0.2371},
}
# Kernel 3 against its plain version teacher-forced on the kernel's tokens.
# The plain version sums in the kernel's order and agrees with it to the
# bit on the H100 with torch 2.11. The tolerance is for a torch whose exp
# or sigmoid rounds otherwise: int8 requantization turns a last-bit
# difference into a whole code step now and then, and through 4 layers and
# the 32-slot KV cache of random weights that grows to ~0.1 of the logits'
# std — as much as the plain version moves when its input moves by 1e-6
# (measured beside the kernel below). So the logits may differ by at most
# this share of their std, and a pick only where the plain top-2 margin is
# below it.
FLIP_MARGIN_TOL = 0.3
MIN_AGREEMENT = 0.99
# Kernel 5 (grouped-affine matvec): bits 4 and 8 at group 64 on every
# quantized linear of the affine path (W8A8_SHAPES and the backbone o and
# the decoder's o, gate-up and down), and group 128 at 4 bits on the
# gate-up. Rows: 1 (single-stream decode), 2 (the dispatched decoder's
# prime, every frame), 8, 16, 32 (the 32-row prefill) and 64.
AFFINE_SHAPES = {
    **W8A8_SHAPES,
    "backbone o": (2048, 2048),
    "decoder o": (1024, 1024),
    "decoder gate-up": (1024, 16384),
    "decoder down": (8192, 1024),
}
AFFINE_ROWS = (1, 2, 8, 16, 32, 64)
# the cases before the redesign draw from gen45 as they did (W8A8_SHAPES,
# these rows); the rest from a generator of their own
AFFINE_EARLIER_ROWS = (1, 2, 8, 32, 64)
AFFINE_LIBRARY_ROWS = (1, 8, 64)  # library yardsticks on the 4-bit gate-up
# kernel-5 launches of one affine frame by (shape, rows): the backbone step
# at 1 row, the dispatched decoder's prime at 2 (projection + 4 layers)
# and its 30 steps at 1; and of the 32-row prefill (the backbone at 32)
AFFINE_FRAME_LAUNCHES = {
    **{(f"backbone {k}", 1): 16 for k in ("qkv", "o", "gate-up", "down")},
    **{(f"decoder {k}", r): n for k in ("qkv", "o", "gate-up", "down")
       for r, n in ((2, 4), (1, 120))},
    ("projection", 2): 1,
    ("projection", 1): 30,
}
AFFINE_PREFILL_LAUNCHES = {(f"backbone {k}", 32): 16
                           for k in ("qkv", "o", "gate-up", "down")}
AFFINE_FRAMES = {4: 20, 8: 5}  # frames of the full-width affine runs
# Kernel 4 (flash decode), H=32, n_kv=8, D=64: (B, cap) cases. cap 40 is
# the batch phase's (a 32-row bucket + 8 frames), 157 that of a 125-frame
# run. Tolerances: the JAX tests' own (tests/test_flash_attention.py).
FLASH_DECODE_CASES = ((8, 157), (64, 40), (64, 157), (64, 1024), (8, 2048))
FLASH_DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# written over the cache keys and values a decode step must not read: one
# of them read would swamp its row's softmax and output
KV_POISON = 1e4
# Kernel 4's split edges, (B, cap, index, pads): at (8, 2048) the cache
# splits into 8 chunks of 256 keys — an index on the last slot of a chunk
# and on the first of the next, pad and index inside one chunk, a row with
# pad > index (no valid key: the average of all cap V rows); cap 1000
# (16 chunks of 64, the last of 40) divides by no split count.
FLASH_DECODE_EDGES = ((8, 2048, 255, None), (8, 2048, 256, None),
                      (8, 2048, 1000, "one chunk"), (8, 2048, 500, "pad > index"),
                      (3, 1000, 999, "pad > index"))
BATCH_ROWS, BATCH_FRAMES = 64, 8  # the batch flash-decode phase
# stream_generate: frames of the checked stream; timed streams a setting
# and their frames. The streamed waveform against the batch decode of the
# same frames: max |err| over max |waveform| (fp32 with TF32 off on both;
# the ring attention and the chunked convs sum in other orders)
STREAM_FRAMES, STREAM_TIMED, STREAM_TIMED_FRAMES = 125, 5, 15
STREAM_TOL = 1e-4
# Context audio: the two context segments' seconds (the first is also the
# encoder check's input); greedy frames of the context prompt; streams a
# setting timed to their first chunk; frames of the 4-row generate_batch.
# The encoder on the card against the CPU: the latent before the RVQ within
# ENCODE_LATENT_TOL of its largest magnitude (fp32, TF32 off: sum order
# only); at least ENCODE_MIN_AGREEMENT of the codes equal, and where a
# codebook's pick first differs, a score gap below ENCODE_TIE of the score
# scale (a near tie that the sum order can flip)
CONTEXT_SECONDS = (10, 8)
CONTEXT_FRAMES, CONTEXT_STREAMS, CONTEXT_BATCH_FRAMES = 40, 5, 10
ENCODE_LATENT_TOL = 1e-4
ENCODE_MIN_AGREEMENT = 0.99
ENCODE_TIE = 1e-3
SAMPLED_FRAMES = 40  # frames of the T = 0.8 captured run
# The serving phase: the continuous engine at its defaults (64 slots,
# K = 8 frames a block, prompt buckets up to 512) takes SERVE_REQUESTS
# 32-row prompts with max_frames drawn in SERVE_FRAMES, the first 64 at once
# and the rest as slots free, and the two context requests of run_context
# for SERVE_CONTEXT_FRAMES frames (their low pads hold the index up, so the
# KV bucket grows); then SERVE_TAIL short requests (an eager rebase and a
# shrink).
SERVE_SLOTS, SERVE_K = 64, 8
SERVE_REQUESTS, SERVE_FRAMES, SERVE_CONTEXT_FRAMES = 96, (10, 60), 300
SERVE_TAIL = 8
SERVE_SOLO = 8      # requests held to their solo runs
SERVE_AB_FRAMES = 48  # frames a request of the captured/eager A/B (6 blocks)
SERVE_AB_CAP = 64     # max_frames of the A/B engines (capacity 704)
SERVE_SAMPLED_FRAMES = 40
SERVE_HTTP_MS = 1600  # audio a request of the HTTP servers
WATERMARK_KEY, WATERMARK_MS = 7, 3200
PROFILE_FRAMES = 4  # frames a profiled frame-step run
PROFILE_PAD_S = 0.1  # idle host time at each end of a profiler window
PROFILE_MARK = "chip_smoke synchronized"  # `padded`'s host span
# device kernels of a wrapper, by a part of their name: one per launch
PROFILED_KERNELS = {
    "w8a8_matvec": ("w8a8_matvec_kernel", "w8a8_gemm_kernel"),
    "resident_decode_frame": ("resident_frame_kernel",),
    "affine_matvec": ("affine_matvec_kernel", "affine_mma_kernel"),
}
PREFILL_ROWS = (300, 1100)  # prompts of the 512- and 2048-row buckets
# End-to-end times before kernel 1's GEMM route and kernel 3's redesign, on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5), printed beside this
# run's: device ms of one B=1 prefill with kernel 2 and with the masked
# path, by prompt rows; ms per frame with kernel 4 on / off, by batch label
PREFILL_RECORDED_MS = {300: (33.93, 38.25), 1100: (142.21, 197.37)}
FRAME_RECORDED_MS = {"batch of 64": (119.91, 124.14),
                     "batch of 8": (45.85, 52.05),
                     "single stream": (35.06, 36.13)}
# One backbone step through kernel 4 against the masked sdpa on an
# unquantized CSM-1B, max |hidden err| / max |hidden| through 16 layers.
# fp32: sum order and expf only. bf16: the JAX tests' bf16 tolerance (both
# round the normalised P to bf16 before P.V, but sum in other orders, and
# each layer rounds its output).
STEP_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# Kernels 6 and 7 at the backbone's shape: (B, S) cases; H = 32, n_kv = 8,
# D = 64, scale 1/8. Tolerances on max |kernel - plain| over max |plain|,
# for O, dq, dk and dv. fp32 (CUDA cores): both sum in fp32 in other orders
# (exp, the online softmax against a one-pass one); 2e-5 is ~10x what fp32
# runs at S = 2048 show. bf16 (tensor cores) is looser: the inputs are the
# same bf16 values and every sum is fp32, but the kernels round P and dS to
# bf16 where they feed their second products (the plain versions keep them
# fp32), both round the outputs to bf16 (2^-8 of each value), and the
# kernel's delta = rowsum(dO * O) reads the bf16 O where the plain one
# reads its fp32 O. The logsumexp is held to FLASH_TRAIN_LSE_TOL absolute
# in both types.
FLASH_TRAIN_CASES = ((2, 575), (1, 2048))
# Recorded bf16 times of kernels 6 and 7 at those cases, us (fwd, bwd), on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this
# run's: kernel 6's code is shared with kernel 2
FLASH_TRAIN_RECORDED_US = {(2, 575): (21.9, 74.7), (1, 2048): (82.1, 314.9)}
FLASH_TRAIN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_TRAIN_LSE_TOL = 1e-4
# the device kernels of csrc/flash_train.cu, by name, for the traces
FLASH_TRAIN_KERNELS = ("flash_fwd_tc_kernel", "flash_delta_tc_kernel",
                       "flash_bwd_tc_kernel", "flash_dkdv_reduce_kernel",
                       "flash_fwd_kernel", "flash_delta_kernel",
                       "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
FLASH_TRAIN_ROUTE = {torch.float32: "CUDA cores, fp32",
                     torch.bfloat16: "tensor cores, mma.sync bf16"}
TRAIN_B, TRAIN_S = 2, 576  # the 64-bucket of 575 frames
# run_parallel: steps a mode, at a learning rate whose AdamW updates (about
# lr an element a step) span several bf16 ulps of the weight matrices
# (|w| ~ 0.02: ulp 1.2e-4); (b)'s gates against the one-process steps (two
# ranks run bf16 GEMMs of one row and sum the gradients in another order):
# losses within PAR_LOSS_RTOL, and each weight matrix's update (after -
# before) within PAR_UPDATE_TOL of the reference update, in norm. A control
# that trains on its own row only (no gradient reduce) must fail that gate.
PAR_STEPS = 2
PAR_LR = 1e-3
PAR_LOSS_RTOL = 1e-3
PAR_UPDATE_TOL = 0.2
PAR_TIMEOUT_S = 480  # (b)'s two ranks, start-up included
RING_SHAPE = (1, 32, 2048, 8, 64)  # B, heads, S, kv heads, D
RING_TOL = {torch.float32: (2e-5, 5e-4),  # forward, gradients
            torch.bfloat16: (2e-2, 2e-2)}
PIPE_B, PIPE_MICRO, PIPE_TOL = 4, 4, 2e-2
# One gloo batch_isend_irecv of a CUDA tensor between two processes on
# cuda:0 (argv: rank, FileStore path)
P2P_PROBE = """
import datetime, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 2),
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=30))
x = torch.full((4,), float(rank), device="cuda:0")
y = torch.empty_like(x)
for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                 dist.P2POp(dist.irecv, y, 1 - rank)]):
    w.wait()
torch.cuda.synchronize()
print("received", y.tolist())
"""
# H100 SXM, NVIDIA's data sheet: HBM bytes/s and dense peak ops/s by type
# The voice chat (run_voice_chat): the app's TTS sampler defaults, and
# sentences of VOICE_SENTENCE_MS (35 frames) so that six context segments
# (>= 8 text rows and 36 audio rows each) and a sentence make a prompt of
# >= 256 rows; VOICE_REPLIES are the
# scripted streaming LLM's answers, one a turn (the last one's turn is
# interrupted), and VOICE_AFFINE_REPLY the affine model's turn.
VOICE_SAMPLER = SamplerConfig(temperature=0.6, top_k=50, top_p=1.0,
                              min_p=0.05)
VOICE_SENTENCE_MS = 2800
VOICE_REPLIES = (
    "Sure, I can help with that. The station is two streets to the north. "
    "You will see it after the bakery.",
    "The next train leaves at noon. It takes about forty minutes to the "
    "city. Tickets are sold on the platform.",
    "Yes, there is a cafe inside. It opens at seven every morning. The "
    "coffee there is quite good.",
    "Let me tell you a longer story about the old bridge. It was built a "
    "century ago by the river guild. Nobody remembers who drew the plans.",
)
VOICE_AFFINE_REPLY = ("The weather will be mild tomorrow. Bring a light "
                      "jacket anyway. Rain may come in the evening.")
VOICE_TURN_S = 120  # a turn's deadline
# The int8 codec (run_int8_codec): JAX's bounds (tests/test_mimi_quant.py)
# on the relative RMSE of the int8 decode against the fp32 one, batch and
# streamed against batched; the engine A/B's requests.
CODEC_BATCH_RMSE, CODEC_STREAM_RMSE = 0.12, 0.05
CODEC_ENGINE_RMSE = 0.15  # JAX's engine bound (tests/test_continuous.py)
CODEC_STREAM_FRAMES = 6   # the frames of JAX's streamed-against-batched case
# JAX's 0.05 on that case holds on its tiny codec; at Mimi(32)'s size JAX
# itself reads 0.057 (tests/test_torch_mimi_quant.py), so the card's value
# is held to the CPU copy's, within this share of it (the int8 rounding of
# fp32 noise moves it a little)
CODEC_CPU_SHARE = 0.1
CODEC_AB_FRAMES = 24  # frames a request of the engine A/B (3 blocks)
CODEC_CONV_ROWS = 4   # batch rows of the int8 convs' bit-equality check
# The async checkpoints (run_training (f)): steps with a save each
ASYNC_STEPS, SYNC_STEPS = 3, 1
# Sharded serving (`run_mesh_serving`): (a) one NCCL rank, a
# {data: 1, model: 1} mesh; (b) two gloo ranks on the one card
MESH_FRAMES = 20          # frames of each (a) prompt
MESH_LONG_ROWS = 300      # the (a) prompt that takes kernel 2
MESH_SLOTS, MESH_K = 16, 8
MESH_REQ_FRAMES = (8, 16, 24, 12)  # (a)'s 16 requests cycle over these
MESH_GLOO_ROWS, MESH_GLOO_FRAMES = 4, 10
MESH_GLOO_REQ_FRAMES = (8, 12, 16, 10)
MESH_TIMEOUT_S = 300      # (b)'s two ranks, start-up included
# (b)'s layouts (the heads or rows of a rank against the one-process
# run's) change the order of fp32 sums: their noise in the teacher-forced
# logits, over the logits' std, stays below this; the W8A8 int8 codes
# amplify a last-bit change to whole code steps (PERF.md §6)
FORCED_SPREAD_TOL = 0.1
# kernel 1's in-sharded entries at a model axis of 2: (local IN, OUT)
TP_IN_SHAPES = {"o_proj": (1024, 2048), "down_proj": (4096, 2048)}
TP_IN_ROWS = (1, 64)
TP_IN_TABLE_BYTES = 80 << 20  # codes cycled a timing, > the 50 MB L2
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    """Every launch counter of the port's registry (`ops.launches`, where
    each wrapper registers its own) to 0, just before a path is driven."""
    launch_registry.reset()


def read_counts() -> dict:
    """Every launch count of the registry, by its wrapper's name (and
    `w8a8_matvec.gemm`, the share of kernel 1's launches on its GEMM
    route)."""
    return launch_registry.read()


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, wall ms) of one call, each a mean over `reps` calls.

    Wall ms: CUDA events around `reps` calls as the host issues them — at
    small shapes the host launches slower than the card computes, so this
    is the host's time. Device ms: the same `reps` calls queued behind a
    spin kernel (`torch.cuda._sleep`) that lasts longer than the host takes
    to issue them, so the events bracket the card's own work, back to back.
    (torch.profiler's device events were tried first and dropped kernels:
    it once reported kernel 6 faster than the card's fp32 peak allows.) A
    call that synchronizes inside gets no head start: its device ms is
    then its wall ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    # 2.5e6 cycles a ms is above the H100's top clock: the spin lasts at
    # least twice the host's issue time plus a millisecond, up to 0.2 s
    torch.cuda._sleep(int(min(2 * host_ms + 1, 200) * 2.5e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, wall


def bound_ms(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def int_mm_ms(x, weights: list) -> float:
    """Device ms of `torch._int_mm` (cuBLASLt) on the same int8 codes as
    kernel 1's GEMM route: the yardstick, without the quantization and the
    fix-up; the port never calls it. It cycles over `weights` as kernel 1's
    timing does, so both read the codes as warm or as cold in L2."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6)
    xq = torch.clamp(torch.round(xf * (127.0 / absmax)), -127,
                     127).to(torch.int8)
    wts = [w.t() for w in weights]
    it = iter(range(1 << 30))
    return time_ms(lambda: torch._int_mm(xq, wts[next(it) % len(wts)]))[0]


def kernel1_vs_plain(x, q: dict) -> tuple:
    """Kernel 1 and `w8a8_matvec_plain` on `x` and the codes of `q`: (the
    largest error, the output's largest magnitude, whether the GEMM route
    took it, ok). Both compute the same int32 products (exact) and the
    same fp32 fix-up, up to the order of the fp32 row sum; bf16 outputs may
    then differ by one bf16 step: ok is every value within 2**-7 of itself
    plus 1e-3 of the output's largest magnitude, finite, on the route of
    its row count."""
    gemm_before = quant.w8a8_matvec.gemm_launches
    got = quant.w8a8_matvec(x, q["weight_q"], q["scales"], q["biases"])
    routed = quant.w8a8_matvec.gemm_launches - gemm_before
    want = quant.w8a8_matvec_plain(x, q["weight_q"], q["scales"],
                                   q["biases"])
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    ok = bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-3 * scale).all()) \
        and bool(torch.isfinite(got).all()) \
        and routed == (x.shape[0] > quant.W8A8_MATVEC_MAX_ROWS)
    return diff.max().item(), scale, bool(routed), ok


def check_w8a8(dev, gen) -> dict:
    """Kernel 1 vs `w8a8_matvec_plain`, on bf16 activations at every row
    count and fp32 ones above 64 rows (the GEMM route). Both compute the
    same int32 products (exact) and the same fp32 fix-up, up to the order of
    the fp32 row sum; bf16 outputs may then differ by one bf16 step:
    tolerance 2**-7 of each value plus 1e-3 of the output's largest
    magnitude. Above 64 rows: the route's launches; at 64 rows (the serving
    engine's slots) and above: the bound and `torch._int_mm`'s time; the
    512-row gate-up beside its recorded time before the GEMM route."""
    worst, timing = 0.0, None
    for name, (in_dim, out_dim) in W8A8_SHAPES.items():
        w = torch.randn((out_dim, in_dim), generator=gen, device=dev) * 0.02
        copies = [quant.quantize_weight_w8(w)]
        n_copies = max(1, -(-COLD_BYTES // (in_dim * out_dim)))
        for _ in range(n_copies - 1):
            copies.append({k: v.clone() for k, v in copies[0].items()})
        for rows in W8A8_ROWS:
            x32 = torch.randn((rows, in_dim), generator=gen, device=dev)
            dtypes = (torch.bfloat16, torch.float32) \
                if rows > quant.W8A8_MATVEC_MAX_ROWS else (torch.bfloat16,)
            for dtype in dtypes:
                x = x32.to(dtype)
                q = copies[0]
                err, scale, routed, ok = kernel1_vs_plain(x, q)
                it = iter(range(1 << 30))

                def run_kernel():
                    c = copies[next(it) % n_copies]
                    quant.w8a8_matvec(x, c["weight_q"], c["scales"],
                                      c["biases"])

                def run_plain():
                    c = copies[next(it) % n_copies]
                    quant.w8a8_matvec_plain(x, c["weight_q"], c["scales"],
                                            c["biases"])

                ms_k, wall_k = time_ms(run_kernel)
                ms_p, wall_p = time_ms(run_plain)
                gbs = in_dim * out_dim / (ms_k * 1e-3) / 1e9
                route = ("tensor cores" if routed else "matvec")
                extra = ""
                # the GEMM route, and 64 rows: the continuous engine's slots
                if routed or rows == quant.W8A8_MATVEC_MAX_ROWS:
                    esz = x.element_size()
                    n_bytes = (in_dim * out_dim + 8 * out_dim
                               + rows * (in_dim + out_dim) * esz)
                    b_ms, b_by = bound_ms(n_bytes, 2 * rows * in_dim
                                          * out_dim, "int8")
                    lib = int_mm_ms(x, [q["weight_q"]])
                    extra = (f"  bound {b_ms:.4f} ms ({b_by}) = "
                             f"{b_ms / ms_k:.1%} of the kernel; "
                             f"torch._int_mm on the same codes {lib:.4f} ms")
                log(f"w8a8 {name:17s} B={rows:4d} {str(dtype)[6:]:8s} "
                    f"IN={in_dim:5d} OUT={out_dim:5d} [{route}]"
                    f"  max_abs_err={err:.3e} (tol 2^-7*|y| + "
                    f"{1e-3 * scale:.2e})  kernel {ms_k:.4f} ms device "
                    f"({gbs:.0f} GB/s of weights), {wall_k:.4f} ms wall  "
                    f"plain {ms_p:.4f} ms device, {wall_p:.4f} ms wall"
                    f"{extra}  {'ok' if ok else 'MISMATCH'}")
                if name == "backbone gate-up" and rows in W8A8_RECORDED_US \
                        and dtype == torch.bfloat16:
                    log(f"w8a8 backbone gate-up B={rows} record: kernel "
                        f"{1e3 * ms_k:.2f} us (before the GEMM route, H100 "
                        f"80GB HBM3, 700 W: {W8A8_RECORDED_US[rows]} us), "
                        f"plain "
                        f"{1e3 * ms_p:.2f} us{extra}")
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(f"w8a8 kernel disagrees at {name} "
                                         f"B={rows} {dtype}")
                if name == "backbone gate-up" and rows == 1:
                    timing = (ms_k, ms_p)
        del copies
    # the JSON line times the widest decode matvec: B=1 on gate-up
    in_dim, out_dim = W8A8_SHAPES["backbone gate-up"]
    n_bytes = in_dim * out_dim + 8 * out_dim + 2 * in_dim + 2 * out_dim
    b_ms, b_by = bound_ms(n_bytes, 2 * in_dim * out_dim, "int8")
    log(f"w8a8 bound at B=1 gate-up: {n_bytes / 1e6:.2f} MB -> {b_ms:.4f} ms"
        f" ({b_by}); kernel {timing[0]:.4f} ms = {b_ms / timing[0]:.1%} of it")
    return dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1],
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_flash(dev, gen, gen_new) -> dict:
    """Kernel 2 vs `flash_prefill_plain` at B=2, H=32, n_kv=8, D=64, over
    k/v slices of a cache-shaped buffer and a transposed q projection, on
    rows past each pad; every row finite, a second call bit-equal. fp32
    (CUDA cores): atol 1e-4 (sum order; exp). bf16 (tensor cores): atol
    3e-2 — both round P to bf16 before P.V, in other places, and both round
    the output to bf16. Timed at FLASH_TIMED_PADS beside the plain version,
    and in bf16 beside SDPA with the same mask and the bound (the causal
    pairs' products at the bf16 peak against the bytes). Inputs: `gen` for
    the first cases, `gen_new` for the rest (FLASH_EARLIER_PADS)."""
    worst, out = 0.0, None
    b, h, n_kv, d = 2, 32, 8, 64
    for s, dtype in FLASH_CASES:
        for pads in FLASH_PADS:
            g = gen if s < 2048 and pads in FLASH_EARLIER_PADS else gen_new
            cap = s + 125
            # q as the projection gives it: (B, S, H, D) seen as (B, H, S, D)
            q = torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)
            q = q.transpose(1, 2).contiguous().transpose(1, 2)
            kc = torch.randn((b, n_kv, cap, d), generator=g,
                             device=dev).to(dtype)
            vc = torch.randn((b, n_kv, cap, d), generator=g,
                             device=dev).to(dtype)
            pad = torch.tensor(pads, dtype=torch.long, device=dev)  # as
            # generation holds the pads: the wrapper passes them on as they are
            k, v = kc[:, :, :s], vc[:, :, :s]
            got = attention.flash_prefill_sdpa(q, k, v, d ** -0.5, pad)
            again = attention.flash_prefill_sdpa(q, k, v, d ** -0.5, pad)
            want = attention.flash_prefill_plain(q, k, v, d ** -0.5, pad)
            torch.cuda.synchronize()
            tol = 1e-4 if dtype == torch.float32 else 3e-2
            err = max((got[i, :, p:].float() - want[i, :, p:].float()).abs()
                      .max().item() for i, p in enumerate(pads))
            repeat = torch.equal(got, again)
            ok = err <= tol and bool(torch.isfinite(got).all()) and repeat
            line = (f"flash S={s} {str(dtype):14s} pads={pads}  max_abs_err="
                    f"{err:.3e} (tol {tol:g}), every row finite, repeat "
                    f"bit-equal {repeat}")
            if pads == FLASH_TIMED_PADS:
                ms_k, wall_k = time_ms(lambda: attention.flash_prefill_sdpa(
                    q, k, v, d ** -0.5, pad))
                ms_p = time_ms(lambda: attention.flash_prefill_plain(
                    q, k, v, d ** -0.5, pad), reps=5, warmup=1)[0]
                line += (f"  kernel {ms_k:.4f} ms device, {wall_k:.4f} ms "
                         f"wall  plain {ms_p:.4f} ms")
                if dtype == torch.bfloat16:
                    library = time_sdpa(q, k, v, pad, d ** -0.5)
                    pairs = sum((s - p) * (s - p + 1) // 2 for p in pads)
                    n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) \
                        + 4 * b
                    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * pairs, "bf16")
                    line += (f"  sdpa {library:.4f} ms  bound {b_ms:.4f} ms "
                             f"({b_by}) = {b_ms / ms_k:.1%} of the kernel; "
                             f"kernel / sdpa {ms_k / library:.2f}x")
                    if s == 512:  # the JSON line: the main path's bucket
                        out = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=library)
            log(line + f"  {'ok' if ok else 'MISMATCH'}")
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"flash kernel disagrees at S={s} "
                                     f"{dtype} pads {pads}")
    return dict(max_abs_err=worst, **out)


def time_sdpa(q, k, v, pad, scale) -> float:
    """Device ms of one `F.scaled_dot_product_attention` call computing
    kernel 2's function (causal, keys before each row's pad masked with the
    same finite bias) on the same inputs. Timed here only: the port never
    calls it."""
    import torch.nn.functional as F

    b, h, s, _ = q.shape
    group = h // k.shape[1]
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    pos = torch.arange(s, device=q.device)
    keep = (pos[None, :] <= pos[:, None])[None] \
        & (pos[None, None, :] >= pad[:, None, None])
    bias = torch.where(keep, 0.0, attention.NEG_INF).to(q.dtype)[:, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, attn_mask=bias, scale=scale))[0]


def affine_cases():
    """(name, IN, OUT, bits, group, earlier) of kernel 5's check; earlier:
    the case was checked before the redesign and keeps its inputs."""
    for name, (in_dim, out_dim) in W8A8_SHAPES.items():
        for bits in (4, 8):
            yield name, in_dim, out_dim, bits, 64, True
    in_dim, out_dim = W8A8_SHAPES["backbone gate-up"]
    yield "backbone gate-up", in_dim, out_dim, 4, 128, True
    for name, (in_dim, out_dim) in AFFINE_SHAPES.items():
        if name not in W8A8_SHAPES:
            for bits in (4, 8):
                yield name, in_dim, out_dim, bits, 64, False


def affine_bytes(in_dim, out_dim, bits, group, rows) -> tuple[int, int]:
    """(code bytes, all bytes kernel 5 must move): codes, fp32 scales and
    biases, bf16 x read once and y written once."""
    codes = in_dim * out_dim * bits // 8
    return codes, codes + 8 * out_dim * (in_dim // group) \
        + 2 * rows * (in_dim + out_dim)


def check_affine_bits(q, x64, want64) -> None:
    """Kernel 5 gives a row the same bits whatever B it is launched with,
    within each of its bf16 routes, and on a repeat: the first B rows of a
    64-row call against calls on them (the tensor-core route, B above the
    library's csm_affine_core_rows()), and single rows against the same
    rows in a call of that many rows (the CUDA-core route)."""
    def run(x):
        return quant.affine_matvec(x, q["weight_q"], q["scales"],
                                   q["biases"])

    edge = _build.library().csm_affine_core_rows()
    if not torch.equal(run(x64), want64):
        raise AssertionError("affine kernel: a repeat gave other bits")
    for b in AFFINE_ROWS[:-1]:
        if b > edge and not torch.equal(run(x64[:b]), want64[:b]):
            raise AssertionError(f"affine kernel: rows of B={b} differ "
                                 f"from the same rows at B=64")
    for r in (0, 31, 62):
        if not torch.equal(run(x64[r:r + 1]),
                           run(x64[r:r + edge])[:1]):
            raise AssertionError(f"affine kernel: row {r} alone differs "
                                 f"from row {r} at B={edge}")


def check_affine(dev, gen, gen_new) -> dict:
    """Kernel 5 vs `affine_matvec_plain` on bf16 activations, at the affine
    path's quantized linears, 4- and 8-bit codes, group 64 (and 128), rows
    AFFINE_ROWS; weights cycled through COLD_BYTES so the L2 is cold. The
    tensor-core route (B above the library's csm_affine_core_rows()) sums s * sum(q x) + z *
    sum(x) per group with exact products; the CUDA-core route and the plain
    version multiply x by the fp32 dequantized weight: fp32 sums in other
    orders, then bf16 rounds: tolerance 2**-7 of each value plus 1e-3 of the
    output's largest magnitude (check_w8a8's). Rows are bit-equal across B
    and repeats (check_affine_bits). Prints kernel 5's device time of one
    affine frame and of the 32-row prefill from the shapes' times."""
    worst, out, times = 0.0, None, {}
    core_rows = _build.library().csm_affine_core_rows()
    for name, in_dim, out_dim, bits, group, earlier in affine_cases():
        g_w = gen if earlier else gen_new
        w = torch.randn((out_dim, in_dim), generator=g_w, device=dev) * 0.02
        copies = [quant.quantize_weight(w, bits, group)]
        code_bytes, _ = affine_bytes(in_dim, out_dim, bits, group, 1)
        n_copies = max(1, -(-COLD_BYTES // code_bytes))
        for _ in range(n_copies - 1):
            copies.append({k: v.clone() for k, v in copies[0].items()})
        for rows in AFFINE_ROWS:
            g_x = gen if earlier and rows in AFFINE_EARLIER_ROWS else gen_new
            x = torch.randn((rows, in_dim), generator=g_x,
                            device=dev).to(torch.bfloat16)
            q = copies[0]
            got = quant.affine_matvec(x, q["weight_q"], q["scales"],
                                      q["biases"])
            want = quant.affine_matvec_plain(x, q["weight_q"], q["scales"],
                                             q["biases"])
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            scale = want.float().abs().max().item()
            err = diff.max().item()
            ok = bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-3 * scale)
                      .all()) and bool(torch.isfinite(got).all())
            it = iter(range(1 << 30))

            def run(fn):
                c = copies[next(it) % n_copies]
                return fn(x, c["weight_q"], c["scales"], c["biases"])

            ms_k, wall_k = time_ms(lambda: run(quant.affine_matvec))
            ms_p = time_ms(lambda: run(quant.affine_matvec_plain), reps=10)[0]
            _, n_bytes = affine_bytes(in_dim, out_dim, bits, group, rows)
            b_ms, b_by = bound_ms(n_bytes, 2 * rows * in_dim * out_dim,
                                  "bf16")
            gbs = (n_bytes - 2 * rows * (in_dim + out_dim)) / ms_k / 1e6
            times[name, bits, group, rows] = ms_k
            route = ("CUDA cores" if rows <= core_rows else "tensor cores")
            log(f"affine {name:17s} {bits}-bit g{group:<3d} B={rows:2d} "
                f"IN={in_dim:5d} OUT={out_dim:5d}  max_abs_err={err:.3e} "
                f"(tol 2^-7*|y| + {1e-3 * scale:.2e})  kernel {ms_k:.4f} ms "
                f"device ({gbs:.0f} GB/s of codes + scales), {wall_k:.4f} "
                f"ms wall  plain {ms_p:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
                f" = {b_ms / ms_k:.1%} of the kernel  [{route}]  "
                f"{'ok' if ok else 'MISMATCH'}")
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"affine kernel disagrees at {name} "
                                     f"{bits}-bit g{group} B={rows}")
            if (name, bits, group) == ("backbone gate-up", 4, 64) \
                    and rows in AFFINE_LIBRARY_ROWS:
                library = time_ms(lambda: run(dequant_matmul))[0]
                log(f"affine gate-up 4-bit g64 B={rows}: dequant + "
                    f"torch.matmul (bf16) {library:.4f} ms device")
                int4pack(x, q, group, want)
                if rows == 1:
                    out = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library)
        check_affine_bits(copies[0], x, got)
        log(f"affine {name} {bits}-bit g{group}: rows bit-equal across "
            f"B = {', '.join(str(b) for b in AFFINE_ROWS if b > core_rows)}"
            f" (tensor cores) and B = 1, {core_rows} (CUDA cores), and on a "
            f"repeat")
        del copies
        torch.cuda.empty_cache()
    for label, launches in (("one affine frame", AFFINE_FRAME_LAUNCHES),
                            ("the 32-row prefill", AFFINE_PREFILL_LAUNCHES)):
        total = sum(n * times[name, 4, 64, rows]
                    for (name, rows), n in launches.items())
        log(f"kernel 5 (4-bit g64) device time of {label}: "
            f"{1e3 * total:.1f} us over {sum(launches.values())} launches")
    return dict(max_abs_err=worst, **out)


def dequant_matmul(x, weight_q, scales, biases):
    """The library yardstick of kernel 5: the weight dequantized to x's
    type, then one `torch.matmul` (the route of quant_linear above 64
    rows)."""
    w = quant.dequantize_weight(
        {"weight_q": weight_q, "scales": scales, "biases": biases},
        quant.code_bits(weight_q, x.shape[-1]), x.dtype)
    return torch.matmul(x, w.t())


def int4pack(x, q, group, want) -> None:
    """`torch._weight_int4pack_mm` (tinygemm) on the same 4-bit codes,
    where this torch has it: time and error against the plain version. It
    takes bf16 scales and zeros (w = (q - 8) * s + zero, so zero = z + 8 s),
    not the fp32 ones of kernel 5: a yardstick of speed, not the same
    function. Timed here only; the port never calls it."""
    if not hasattr(torch, "_weight_int4pack_mm"):
        log("torch._weight_int4pack_mm: not in this torch")
        return
    codes = quant.unpack_uint4(q["weight_q"]).to(torch.int32)
    packed = ((codes[:, 0::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    sz = torch.stack([q["scales"], q["biases"] + 8 * q["scales"]], dim=-1)
    sz = sz.transpose(0, 1).contiguous().to(torch.bfloat16)
    try:
        w4 = torch._convert_weight_to_int4pack(packed, 8)
        y = torch._weight_int4pack_mm(x, w4, group, sz)
    except (RuntimeError, TypeError) as e:
        log(f"torch._weight_int4pack_mm refused these inputs: {e}")
        return
    err = (y.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: torch._weight_int4pack_mm(x, w4, group, sz))[0]
    log(f"affine gate-up 4-bit g{group} B={x.shape[0]}: "
        f"torch._weight_int4pack_mm {ms:.4f} ms device (bf16 scales and "
        f"zeros), max |err| against the plain version {err:.3e} of max "
        f"|y| {want.float().abs().max().item():.3e}")


def decode_inputs(gen, dev, dtype, b, cap, index, pads):
    """q as a transposed projection, k/v the layer views of a 2-layer
    cache, H=32, n_kv=8, D=64; pads random below 32 (prompts of a 32-row
    bucket), all index - 20 for "one chunk", the last row's index + 1 for
    "pad > index"."""
    h, n_kv, d = 32, 8, 64
    q = torch.randn((b, 1, h, d), generator=gen,
                    device=dev).to(dtype).transpose(1, 2)
    kc, vc = (torch.randn((2, b, n_kv, cap, d), generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    pad = torch.randint(0, min(32, index + 1), (b,), generator=gen,
                        device=dev)
    if pads == "one chunk":
        pad.fill_(index - 20)
    elif pads == "pad > index":
        pad[-1] = index + 1
    return q, kc[1], vc[1], pad


def check_flash_decode(dev, gen, gen_new) -> dict:
    """Kernel 4 vs `flash_decode_plain` at H=32, n_kv=8, D=64 over the
    layer views of a 2-layer cache, fp32 and bf16: FLASH_DECODE_CASES at
    index = cap - 1, then the split edges FLASH_DECODE_EDGES; tolerances
    FLASH_DECODE_TOL on max |err| (bf16: times max |plain| where that is
    below 1), every output finite, a second call bit-equal. The cases are
    timed beside the plain version and `F.scaled_dot_product_attention`
    with the same boolean mask and `enable_gqa`; the bound counts the keys
    each row needs, [pad, index]. At (8, 2048) bf16 the profiler splits the
    time between the split and merge launches. Inputs: `gen` for the
    cases, `gen_new` for the edges."""
    import torch.nn.functional as F

    h, n_kv, d = 32, 8, 64
    worst, out = 0.0, None
    cases = [(b, cap, cap - 1, None) for b, cap in FLASH_DECODE_CASES]
    for b, cap, index, pads in cases + list(FLASH_DECODE_EDGES):
        timed = pads is None and index == cap - 1
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pad = decode_inputs(gen if timed else gen_new, dev,
                                         dtype, b, cap, index, pads)
            # the index as the cache holds it: an int32 on the card, read
            # by the kernel
            idx = torch.full((), index, dtype=torch.int32, device=dev)
            got = attention.flash_decode_sdpa(q, k, v, d ** -0.5, pad, idx)
            again = attention.flash_decode_sdpa(q, k, v, d ** -0.5, pad, idx)
            want = attention.flash_decode_plain(q, k, v, d ** -0.5, pad, idx)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # bf16 shrinks with the output's largest magnitude (never past
            # 2e-2): at long caches the outputs are averages over thousands
            # of keys
            tol = FLASH_DECODE_TOL[dtype] * (
                min(1.0, want.float().abs().max().item())
                if dtype == torch.bfloat16 else 1.0)
            repeat = torch.equal(got, again)
            ok = err <= tol and bool(torch.isfinite(got).all()) and repeat
            splits, chunk = attention.decode_splits(b, n_kv, cap)
            line = (f"flash_decode B={b:2d} cap={cap:4d} index={index:4d} "
                    f"{pads or 'pads < 32'} {str(dtype):14s} {splits} "
                    f"split(s) of {chunk}  max_abs_err={err:.3e} (tol "
                    f"{tol:.3e}), repeat bit-equal {repeat}")
            if timed:
                pos = torch.arange(cap, device=dev)
                keep = ((pos[None] >= pad[:, None])
                        & (pos[None] <= index))[:, None, None]
                ms_k, wall_k = time_ms(lambda: attention.flash_decode_sdpa(
                    q, k, v, d ** -0.5, pad, idx))
                ms_p = time_ms(lambda: attention.flash_decode_plain(
                    q, k, v, d ** -0.5, pad, idx))[0]
                ms_l = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep, scale=d ** -0.5,
                    enable_gqa=True))[0]
                keys = int((index + 1 - pad).sum())
                e = q.element_size()
                n_bytes = 2 * keys * n_kv * d * e + 2 * b * h * d * e + 8 * b
                b_ms, b_by = bound_ms(n_bytes, 4 * keys * h * d,
                                      "bf16" if dtype == torch.bfloat16
                                      else "fp32")
                line += (f"  kernel {ms_k:.4f} ms device, {wall_k:.4f} ms "
                         f"wall  plain {ms_p:.4f} ms  sdpa {ms_l:.4f} ms  "
                         f"bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.2f} "
                         f"MB) = {b_ms / ms_k:.1%} of the kernel; kernel / "
                         f"sdpa {ms_k / ms_l:.2f}x")
                if (b, cap, dtype) == (64, 157, torch.bfloat16):
                    out = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                               bound_by=b_by, library_ms=ms_l)
            log(line + f"  {'ok' if ok else 'MISMATCH'}")
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"flash decode kernel disagrees at B={b}"
                                     f" cap={cap} index={index} {dtype}")
            if timed and (b, cap, dtype) == (8, 2048, torch.bfloat16):
                log("flash_decode B=8 cap=2048 bf16 by launch (K pass, V "
                    "pass, merge): " + launch_split(
                        lambda: attention.flash_decode_sdpa(
                            q, k, v, d ** -0.5, pad, idx), 3))
    return dict(max_abs_err=worst, **out)


def synthetic_prompt(s: int, n_text_vocab: int, seed: int):
    """bench.py's prompt: s random text tokens in column 32, no audio."""
    rng = np.random.RandomState(seed)
    prompt = np.zeros((s, 33), dtype=np.int32)
    prompt[:, -1] = rng.randint(0, n_text_vocab, size=s)
    mask = np.zeros((s, 33), dtype=np.int32)
    mask[:, -1] = 1
    return prompt, mask


def random_csm(args, dtype, dev, seed) -> CSM:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = CSM(args, dtype=dtype, generator=gen, device=dev)
    # The init zeroes audio_head; with a zero head every decoder codebook
    # is 0 and EOS becomes a 1-in-2051 coin flip on c0.
    head = model.params["audio_head"]
    model.params["audio_head"] = (torch.randn(
        head.shape, generator=gen, device=dev) * 0.02).to(dtype)
    return model


def map_params(fn, tree):
    """The params tree with `fn` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_params(fn, v) for v in tree]
    return fn(tree)


def params_to_cpu(tree):
    return map_params(torch.Tensor.cpu, tree)


def resident_bound(res, args, rows: int, code_bits: int = 8
                   ) -> tuple[float, str]:
    """Kernel 3's bound for one call of `rows` rows: every table read once
    (the embed rows this call gathers: 30 per row), proj01 read and the
    tokens written, against the int8 operations of 32 decoder steps and
    31 heads. `code_bits=4`: the layers' codes as packed 4-bit codes would
    be read, half a byte each (W4A8 keeps them in int8 carriers); the
    head stays 8-bit."""
    def nbytes(t):
        return t.numel() * t.element_size()

    d = args.decoder_config.hidden_size
    n_cb = args.n_audio_codebooks
    weights = sum(nbytes(t) for lw in res["layers"] for t in lw)
    n_bytes = (weights + nbytes(res["norm"]) + nbytes(res["rope_cs"])
               + nbytes(res["audio_head_q"]) + nbytes(res["audio_head_s"])
               + (n_cb - 2) * rows * d * 4 + 2 * rows * d * 4
               + n_cb * rows * 4)
    codes = sum(t.numel() for lw in res["layers"] for t in lw
                if t.dtype == torch.int8)
    n_bytes -= codes * (8 - code_bits) / 8
    n_ops = 2 * rows * (n_cb * codes + res["audio_head_q"].numel())
    return bound_ms(n_bytes, n_ops, "int8")


def forced_flips(res, args, proj01, tokens, kernel_logits):
    """Kernel 3's tokens and logits against its plain version
    teacher-forced on the tokens: (share of picks that agree, the flips'
    plain top-2 margins and the largest logit error, both in units of the
    logits' std, and the largest absolute logit error)."""
    _, logits = resident.resident_decode_frame_plain(
        res, args, proj01, 0.0, forced=tokens.long())
    std = logits.std(dim=-1)
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / std
    flips = logits.argmax(-1) != tokens[1:].long()
    err = (kernel_logits - logits).abs()
    return (1.0 - flips.float().mean().item(), margin[flips],
            (err.amax(-1) / std).max().item(), err.max().item())


STAMP_CAP = 4096  # phase records a kernel-3 call may write


def phase_split(res, args, proj01, want_tokens) -> dict:
    """Kernel 3's own phase records over one greedy call (its
    `stamps` buffer): ms of the whole call, of each phase kind (a phase
    from its start to the latest block's arrival at its closing barrier; a
    prologue recorded by block 0 counts to its own kind), and of the
    barriers (the latest arrival to the release), summed over the frame
    and over step 0. The tokens must equal `want_tokens`, the call without
    records."""
    stamps = torch.zeros((STAMP_CAP, 4), dtype=torch.int64,
                         device=proj01.device)
    resident.resident_decode_frame.stamps = stamps
    try:
        toks = resident.resident_decode_frame(
            res, args, proj01, torch.zeros((), dtype=torch.int32,
                                           device=proj01.device), 0.0)
    finally:
        resident.resident_decode_frame.stamps = None
    torch.cuda.synchronize()
    if not torch.equal(toks, want_tokens):
        raise AssertionError("kernel 3's tokens changed with its phase "
                             "records on")
    rec = stamps.cpu().numpy().astype(np.float64)
    n = int((rec[:, 0] != 0).sum())
    rec, codes = rec[:n], stamps[:n, 3].cpu().numpy()
    frame: dict = {}
    step0: dict = {}
    step = -1
    for i in range(n):
        kind = resident.PHASE_KINDS[codes[i] & 0xFF]
        start, pro, arrive = rec[i, 0], rec[i, 1], rec[i, 2]
        if kind == "pick" or (pro and (codes[i] >> 8) & 0xFF == 0):
            step += 1  # a step starts with the pick (or its prologue)
        parts = {}
        if pro:
            parts[resident.PHASE_KINDS[(codes[i] >> 8) & 0xFF]] = pro - start
            parts[kind] = arrive - pro
        else:
            parts[kind] = arrive - start
        if i + 1 < n:
            parts["barrier"] = rec[i + 1, 0] - arrive
        for out in (frame, step0) if step == 0 else (frame,):
            for k, ns in parts.items():
                out[k] = out.get(k, 0.0) + ns / 1e6
    return dict(total_ms=(rec[n - 1, 2] - rec[0, 0]) / 1e6, barriers=n - 1,
                frame=frame, step0=step0)


def fmt_split(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(
        split.items(), key=lambda kv: -kv[1]))


def resident_case(model: CSM, rows: int, g, label: str = "resident"
                  ) -> tuple:
    """Kernel 3 against its plain version at `rows` random proj01 rows,
    greedy, the plain version teacher-forced on the kernel's tokens: every
    logit within FLIP_MARGIN_TOL of its row's std and bit-equal, >= 99% of
    the picks agree, every disagreement sits at a plain top-2 margin below
    FLIP_MARGIN_TOL of the std, and a second launch gives identical
    tokens. Returns (its times and errors, proj01, the tokens)."""
    res, args = model.params["_resident"], model.args
    d = args.decoder_config.hidden_size
    proj01 = torch.randn((2, rows, d), generator=g, device=model.device)
    # the seed as the frame step hands it over: an int32 on the card
    seed = torch.zeros((1,), dtype=torch.int32, device=model.device)
    toks, k_logits = resident.resident_decode_frame(
        res, args, proj01, seed, 0.0, return_logits=True)
    again = resident.resident_decode_frame(res, args, proj01, seed, 0.0)
    torch.cuda.synchronize()
    agree, flip_m, rel_err, abs_err = forced_flips(res, args, proj01,
                                                   toks, k_logits)
    # the plain version against itself, its input moved by 1e-6
    nudged = proj01 * (1 + 1e-6 * torch.randn(
        proj01.shape, generator=g, device=proj01.device))
    _, p_logits = resident.resident_decode_frame_plain(
        res, args, nudged, 0.0, forced=toks.long())
    base = forced_flips(res, args, proj01, toks, p_logits)[2]
    worst = flip_m.max().item() if flip_m.numel() else 0.0
    same = bool(torch.equal(toks, again))
    ok = (agree >= MIN_AGREEMENT and worst < FLIP_MARGIN_TOL and same
          and rel_err <= FLIP_MARGIN_TOL and abs_err == 0.0
          and not bool(toks[0].any()) and int(toks.min()) >= 0
          and int(toks.max()) < args.n_audio_vocab)
    ms_k, wall_k = time_ms(lambda: resident.resident_decode_frame(
        res, args, proj01, seed, 0.0), reps=10)
    # one call each way (about a second at every B): the two forced
    # calls above warmed it at this shape
    ms_p, wall_p = time_ms(lambda: resident.resident_decode_frame_plain(
        res, args, proj01, 0.0), reps=1, warmup=0)
    b_ms, b_by = resident_bound(res, args, rows)
    log(f"{label} B={rows:2d}  max_abs_err {abs_err:.3e} of the logits "
        f"= {rel_err:.4f} std (tol {FLIP_MARGIN_TOL}; plain vs plain "
        f"with its input moved by 1e-6: {base:.4f} std)  agreement "
        f"{agree:.4f} (need >= "
        f"{MIN_AGREEMENT}), logits bit-equal {abs_err == 0.0} (need "
        f"True), {flip_m.numel()} flips, worst margin "
        f"{worst:.4f} std (tol {FLIP_MARGIN_TOL}), repeat identical "
        f"{same}  kernel {ms_k:.4f} ms device, {wall_k:.4f} ms wall  "
        f"plain {ms_p:.4f} ms device, {wall_p:.4f} ms wall  bound "
        f"{b_ms:.4f} ms ({b_by}) = {b_ms / ms_k:.1%} of the kernel  "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"kernel 3 disagrees with its plain version "
                             f"at B={rows} ({label})")
    return (dict(max_abs_err=abs_err, agreement=agree, ms=ms_k,
                 wall_ms=wall_k, plain_ms=ms_p, bound_ms=b_ms,
                 bound_by=b_by), proj01, toks)


def check_resident(model: CSM, gen, gen_new) -> dict:
    """Kernel 3 against its plain version at full CSM-1B width
    (`resident_case`) at RESIDENT_ROWS, each with its phase split."""
    res, args = model.params["_resident"], model.args
    out = {}
    for rows in RESIDENT_ROWS:
        g = gen_new if rows in RESIDENT_NEW_ROWS else gen
        out[rows], proj01, toks = resident_case(model, rows, g)
        split = phase_split(res, args, proj01, toks)
        log(f"resident B={rows:2d} phases (kernel's own records, tokens equal"
            f" to the call without them): {split['total_ms']:.4f} ms, "
            f"{split['barriers']} barriers; frame ms: "
            f"{fmt_split(split['frame'])}; step 0 ms: "
            f"{fmt_split(split['step0'])}")
        if rows in RESIDENT_RECORDED_SPLIT:
            log(f"resident B={rows:2d} before the redesign (H100 80GB HBM3, "
                f"700 W): {RESIDENT_RECORDED_MS[rows]} ms, 1086 barriers; "
                f"frame ms: {fmt_split(RESIDENT_RECORDED_SPLIT[rows])}")
    codes = sum(t.numel() for lw in res["layers"] for t in lw
                if t.dtype == torch.int8)
    n_cb = args.n_audio_codebooks
    head = res["audio_head_q"][0].numel()
    floor = (n_cb * codes + (n_cb - 1) * head) / HBM_BYTES_PER_S * 1e3
    log(f"resident: decoder weights {codes / 1e6:.1f} MB int8, streamed by "
        f"each of {n_cb} steps, and a {head / 1e6:.3f} MB head by each of "
        f"{n_cb - 1}: floor {floor:.3f} ms a frame at the HBM rate (weights "
        f"alone {n_cb * codes / HBM_BYTES_PER_S * 1e3:.3f})")
    return out


def chi_square_p(samples: np.ndarray, probs: np.ndarray) -> tuple:
    """(p-value, bins) of samples against probs over the bins whose
    expected count is >= 5 plus one pooled bin of the rest."""
    from scipy import stats

    expected = probs.astype(np.float64) * len(samples)
    observed = np.bincount(samples, minlength=len(probs)).astype(np.float64)
    big = expected >= 5
    obs = np.append(observed[big], observed[~big].sum())
    exp = np.append(expected[big], expected[~big].sum())
    if exp[-1] < 5:
        obs, exp = obs[:-1], exp[:-1]
    stat = ((obs - exp) ** 2 / exp).sum()
    return float(stats.chi2.sf(stat, len(obs) - 1)), len(obs)


def check_resident_temperature(model: CSM, gen) -> None:
    """Kernel 3 at T = 0.8: codebook 1 of 64 calls of 64 copies of one
    proj01 row (4096 picks, one seed per call) against softmax(plain
    logits_1 / T), chi-square p >= 1e-3. The head is rescaled for this
    phase to a logits std of 3, so that many tokens carry probability."""
    res = dict(model.params["_resident"])
    args = model.args
    row = torch.randn((2, 1, args.decoder_config.hidden_size), generator=gen,
                      device=model.device)
    _, logits = resident.resident_decode_frame_plain(res, args, row, 0.0)
    resident.set_resident_audio_head(
        res, model.params["audio_head"].float()
        * (3.0 / logits[0].std().item()), res["audio_head_q"].shape[1])
    _, logits = resident.resident_decode_frame_plain(res, args, row, 0.0)
    probs = torch.softmax(logits[0, 0] / 0.8, -1).double().cpu().numpy()
    proj01 = row.expand(2, 64, -1).contiguous()
    picks = torch.cat([resident.resident_decode_frame(
        res, args, proj01, torch.full((), seed, dtype=torch.int32,
                                      device=model.device), 0.8)[1]
        for seed in range(64)]).cpu().numpy()
    p, bins = chi_square_p(picks, probs)
    log(f"resident T=0.8: {len(picks)} codebook-1 picks, {len(set(picks))} "
        f"distinct, chi-square over {bins} bins p = {p:.4f} (need >= 1e-3)")
    if not p >= 1e-3 or bins < 5:
        raise AssertionError("kernel 3's samples do not follow softmax/T")


def small_args() -> ModelArgs:
    """A small CSM (2-layer backbone d=256, 2-layer decoder d=128, head_dim
    64, 32 codebooks), registered in the port's config registries."""
    port_config.BACKBONE_CONFIGURATION["smoke_small"] = port_config.LlamaConfig(
        vocab_size=1024, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, intermediate_size=512,
        hidden_size=256)
    port_config.DECODER_CONFIGURATION["smoke_small"] = port_config.LlamaConfig(
        vocab_size=1024, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=64, intermediate_size=256,
        hidden_size=128)
    return ModelArgs("smoke_small", "smoke_small", 1024, 256, 32)


def check_small_vs_cpu(dev, mimi: Mimi) -> None:
    """The main path on a small model, W8A8, fp32, with a 300-row prompt:
    the card (all three kernels) against the CPU (plain versions). The greedy
    frames agree on at least 99% of the codes, and the full-size Mimi
    decodes them alike on both (fp32, TF32 off: sum order only, so within
    1e-4 of the waveform's largest magnitude)."""
    args = small_args()
    gpu = random_csm(args, torch.float32, dev, SEED + 7)
    gpu.params["audio_head"] = gpu.params["audio_head"] * 25.0  # N(0, 0.5^2)
    quant.quantize_model(gpu, mode="w8a8", min_size=0)

    if "_resident" not in gpu.params:
        raise AssertionError("quantize_model on the card prepared no tables")
    # the CPU copy carries the tables: its frames come from kernel 3's
    # plain version
    cpu = CSM(args, params=params_to_cpu(gpu.params), dtype=torch.float32)
    prompt, mask = synthetic_prompt(300, args.n_text_vocab, SEED + 8)
    launches = (attention.flash_prefill_sdpa.launches,
                resident.resident_decode_frame.launches)
    f_gpu, n_gpu = generate_tokens(gpu, prompt, mask, 4, temperature=0.0)
    f_cpu, n_cpu = generate_tokens(cpu, prompt, mask, 4, temperature=0.0)
    if attention.flash_prefill_sdpa.launches == launches[0] \
            or resident.resident_decode_frame.launches - launches[1] != n_gpu:
        raise AssertionError("small-model check did not take flash prefill "
                             "and one kernel-3 launch per frame")
    n = min(n_gpu, n_cpu)
    agree = float((f_gpu[:n] == f_cpu[:n]).mean()) if n else 0.0
    log(f"small model W8A8 fp32, 300-row prompt: card vs CPU frames "
        f"{n_gpu}/{n_cpu}, code agreement {agree:.4f} (need >= 0.99)")
    if n_gpu != n_cpu or agree < 0.99:
        raise AssertionError("card and CPU disagree on the small model")
    codes = torch.from_numpy(f_gpu.T[None].copy())
    wav_gpu = mimi.decode(codes.to(dev)).cpu()
    wav_cpu = Mimi(mimi.cfg, params=params_to_cpu(mimi.params)).decode(codes)
    mimi_err = (wav_gpu - wav_cpu).abs().max().item()
    mimi_tol = 1e-4 * wav_cpu.abs().max().item()
    log(f"Mimi decode of those {n_gpu} frames, card vs CPU: max_abs_err "
        f"{mimi_err:.3e} (tol {mimi_tol:.3e})")
    if not mimi_err <= mimi_tol:
        raise AssertionError("card and CPU Mimi decodes disagree")


def build_csm_1b(dev) -> CSM:
    """CSM-1B at full width and depth, random weights from SEED, bf16,
    W8A8 with fused qkv / gate-up; on the card `quantize_model` also
    prepares kernel 3's tables."""
    args = csm_1b()
    t0 = time.perf_counter()
    model = random_csm(args, torch.bfloat16, dev, SEED)
    quant.quantize_model(model, mode="w8a8", fuse=True)
    torch.cuda.synchronize()
    if "_resident" not in model.params:
        raise AssertionError("quantize_model prepared no kernel-3 tables")
    log(f"CSM-1B random init (seed {SEED}) + W8A8 + kernel-3 tables: "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def captured_vs_eager(run, label: str, n_frames: int,
                      eager_runs: int = 2) -> dict:
    """`run(eager, n_frames)` -> (frames, n) through the captured frame
    step and through the eager one (`_eager_step`). One captured run first
    captures its graph; then the two alternate, captured, eager, eager,
    captured (with `eager_runs=1`, where an eager frame takes hundreds of
    ms: captured, eager, captured), each run's launch counts set to 0 just
    before it and read just after. Gate: the greedy frames of every run are
    equal, token for token. Returns the first captured run's frames, n and
    counts, and ms a frame of both settings, and the first captured
    run's whole ms (its step built, warmed and captured)."""
    t0 = time.perf_counter()
    run(False, n_frames)  # warm-up: the step's first frame, its capture
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    out: dict = {}
    order = (False,) + (True,) * eager_runs + (False,)
    for eager in order:
        reset_counts()
        t0 = time.perf_counter()
        frames, n = run(eager, n_frames)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        frames_made = int(np.max(n))
        if eager not in out:
            out[eager] = dict(frames=frames, n=n, counts=counts, ms=[])
        elif not np.array_equal(frames, out[eager]["frames"]):
            raise AssertionError(f"{label}: two greedy runs differ")
        out[eager]["ms"].append(1e3 * dt / max(frames_made, 1))
    cap, eag = out[False], out[True]
    same = np.array_equal(cap["frames"], eag["frames"]) \
        and np.array_equal(cap["n"], eag["n"])
    log(f"{label}: {int(np.max(cap['n']))} greedy frames, captured vs eager "
        f"step (alternated {'/'.join('eager' if e else 'captured' for e in order)}"
        f"): frames equal token for token {same}; ms a frame captured "
        f"{', '.join(f'{t:.2f}' for t in cap['ms'])}, eager "
        f"{', '.join(f'{t:.2f}' for t in eag['ms'])}; the first captured "
        f"run (its step built, warmed and captured) {first_ms:.1f} ms in "
        f"all, a later one {cap['ms'][0] * int(np.max(cap['n'])):.1f}; "
        f"launches captured {cap['counts']}, eager {eag['counts']}")
    if not same:
        raise AssertionError(f"{label}: the captured step's frames differ "
                             f"from the eager step's")
    return dict(frames=cap["frames"], n=cap["n"], counts=cap["counts"],
                ms_captured=float(np.mean(cap["ms"])),
                ms_eager=float(np.mean(eag["ms"])))


@contextlib.contextmanager
def padded(profiler):
    """Enter `profiler` (a torch.profiler.profile or utils.profiling.trace)
    with PROFILE_PAD_S of idle host time between its start and the body
    and between the body and its stop. The card is synchronized before the
    profiler starts and after the body, and a host span with no device
    work, "chip_smoke synchronized", marks the moment the host saw the
    card idle. The profiler keeps a device event only when its timestamps,
    mapped onto the host's clock, fall inside its window, and that mapping
    can read earlier or later than the host: an unpadded window has lost
    its first or its last launches (PERF.md §6, `window_margins`). Yields
    what the profiler yields."""
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with profiler as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        with record_function(PROFILE_MARK):
            pass
        time.sleep(PROFILE_PAD_S)


def window_margins(events) -> tuple[float, float]:
    """In a `padded` profiler's raw events (`kineto_results.events()`, host
    and device), ms from the first host event's start to the first device
    event's start, and from the last device event's end to the
    "chip_smoke synchronized" mark. The card cannot start a launch before
    the host issues it nor end one after the host saw it end, so a
    negative margin is the shift of the device timestamps' mapping onto
    the host's clock, which the pads cover."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = [e for e in events if e.device_type() == DeviceType.CUDA
           and e.name() != PROFILE_MARK]
    seen = next(e.start_ns() for e in host if e.name() == PROFILE_MARK)
    return ((min(e.start_ns() for e in dev)
             - min(e.start_ns() for e in host)) / 1e6,
            (seen - max(e.start_ns() + e.duration_ns() for e in dev)) / 1e6)


def profile_frames(model: CSM, label: str) -> dict:
    """Device events, device-busy ms and wall ms a frame of the frame step
    (`generation.FrameStep`) at B = 1 from the 32-row prompt, greedy,
    captured and eager: after the prefill, the first frame and two more
    (the captured step's warm-up frame and its capture), PROFILE_FRAMES
    frames under the profiler (`padded`; the wall time is the frames' own),
    each followed by the host's EOS read as in the frame loop. Gate: the device launches of kernels 1, 3 and 5 that
    the profiler saw (PROFILED_KERNELS) equal the wrappers' counts, which
    add a captured step's launches at each replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prompt, mask = synthetic_prompt(32, model.args.n_text_vocab, SEED)
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    out = {}
    for eager in (False, True):
        step = generation.FrameStep(model, 1, bucket + PROFILE_FRAMES + 3,
                                    SamplerConfig(temperature=0.0), (), None,
                                    eager=eager)
        step.first(step.prefill(tokens, masks, pad))
        step()
        step()
        torch.cuda.synchronize()
        reset_counts()
        with padded(profile(activities=acts)) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_FRAMES):
                step()
                bool(step.frame.any())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = read_counts()
        # the raw records: parsing them into the profiler's event tree
        # takes seconds at ~10,000 launches a frame
        raw = list(prof.profiler.kineto_results.events())
        events = [e for e in raw if e.device_type() == DeviceType.CUDA
                  and e.name() != PROFILE_MARK]
        seen = {k: sum(any(n in e.name() for n in names) for e in events)
                for k, names in PROFILED_KERNELS.items()}
        margins = window_margins(raw)
        setting = "eager" if eager else "captured"
        if any(seen[k] != counts[k] for k in seen):
            raise AssertionError(
                f"{label}, {setting}: the profiler saw {seen} kernel "
                f"launches, the counters say {counts}; margins (ms) from "
                f"the host's first event to the first launch "
                f"{margins[0]:.3f}, from the last launch's end to the "
                f"host's synchronized mark {margins[1]:.3f}")
        busy = sum(e.duration_ns() for e in events) / 1e6
        out[setting] = dict(
            events=len(events) / PROFILE_FRAMES,
            busy_ms=busy / PROFILE_FRAMES,
            wall_ms=1e3 * wall / PROFILE_FRAMES,
            k3=seen["resident_decode_frame"] / PROFILE_FRAMES,
            margins=margins)
        del step
    log(f"{label}, a frame of {PROFILE_FRAMES} profiled frames: captured "
        + "; eager ".join(
            f"{r['events']:.0f} device events, {r['busy_ms']:.3f} ms device "
            f"busy of {r['wall_ms']:.2f} ms wall under the profiler "
            f"({r['busy_ms'] / r['wall_ms']:.1%}), {r['k3']:.2f} kernel-3 "
            f"launches, margins (ms) from the host's first event to the "
            f"first launch {r['margins'][0]:.3f}, from the last launch's end "
            f"to the host's synchronized mark {r['margins'][1]:.3f}"
            for r in out.values())
        + "; kernel launches seen by the profiler equal the counters'")
    return out


def run_main_path(model: CSM, mimi: Mimi) -> dict:
    """Drive the main path at full CSM-1B width, greedy: 125 frames from
    the 32-row prompt through the captured frame step against the eager
    one (`captured_vs_eager`), then 10 frames from a 300-row prompt
    (kernel 2 in the prefill) and a Mimi decode of the 125 frames. Returns
    each kernel's launch count in the first captured run and the 300-row
    run (replays count the launches they ran), and ms a frame."""
    args = model.args
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    long_prompt, long_mask = synthetic_prompt(300, args.n_text_vocab, SEED + 1)
    ab = captured_vs_eager(
        lambda eager, n: generate_tokens(model, prompt, mask, n,
                                         temperature=0.0, _eager_step=eager),
        "main path W8A8", 125)
    frames, n = ab["frames"], int(ab["n"])
    counts = dict(ab["counts"])
    before = read_counts()
    gemm0 = quant.w8a8_matvec.gemm_launches
    t0 = time.perf_counter()
    long_frames, n_long = generate_tokens(model, long_prompt, long_mask, 10,
                                          temperature=0.0)
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    after = read_counts()
    counts = {k: counts[k] + after[k] - before[k] for k in counts
              if k in ("w8a8_matvec", "flash_prefill_sdpa",
                       "resident_decode_frame")}
    codes = torch.from_numpy(frames.T[None].copy()).to(model.device)
    t0 = time.perf_counter()
    audio = mimi.decode(codes)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    gemm = quant.w8a8_matvec.gemm_launches - gemm0
    log(f"launches on the main path: {counts} over {n} + {n_long} frames; "
        f"w8a8 GEMM route (prefill, > {quant.W8A8_MATVEC_MAX_ROWS} rows) "
        f"{gemm} in the 300-row run")
    if n < 1 or n_long < 1:
        raise AssertionError(f"no frames generated ({n}, {n_long})")
    for f in (frames, long_frames):
        if f.min() < 0 or f.max() >= args.n_audio_vocab:
            raise AssertionError("codes outside the audio vocabulary")
    if tuple(audio.shape) != (1, 1, n * 1920) \
            or not bool(torch.isfinite(audio).all()):
        raise AssertionError(f"waveform {tuple(audio.shape)} is not "
                             f"{n} * 1920 finite samples")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {counts}")
    if counts["resident_decode_frame"] != n + n_long:
        raise AssertionError("a decoder frame did not go through kernel 3")
    ms = ab["ms_captured"]
    log(f"main path: {ms:.2f} ms a frame captured ({80 / ms:.2f}x real "
        f"time), {ab['ms_eager']:.2f} eager; Mimi decode of {n} frames "
        f"{t_dec:.3f} s; 300-row prompt: {n_long} frames in {t_long:.3f} s;"
        f" waveform {audio.shape[-1]} samples, finite")
    return dict(counts=counts, frames=n + n_long, ms_per_frame=ms,
                ms_eager=ab["ms_eager"], frames_125=frames)


def trace_main_path(model: CSM) -> dict:
    """Device events and busy time a frame of the main path, captured and
    eager (`profile_frames`)."""
    return profile_frames(model, "trace, main path W8A8")


def run_dispatched(model: CSM) -> dict:
    """10 frames of the main path's prompt through the dispatched decoder
    (a shallow copy of the params without kernel 3's tables), captured
    against eager, and its events a frame."""
    args = model.args
    params = {k: v for k, v in model.params.items() if k != "_resident"}
    dispatched = CSM(args, params=params, dtype=model.dtype)
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)

    def run(eager, n):
        return generate_tokens(dispatched, prompt, mask, n, temperature=0.0,
                               _eager_step=eager)

    ab = captured_vs_eager(run, "dispatched decoder", 10, eager_runs=1)
    if ab["counts"]["resident_decode_frame"]:
        raise AssertionError("the dispatched run took kernel 3")
    n = int(ab["n"])
    trace = profile_frames(dispatched, "trace, dispatched decoder")
    log(f"dispatched decoder: {ab['ms_captured']:.2f} ms a frame captured, "
        f"{ab['ms_eager']:.2f} eager; W8A8 launches "
        f"{ab['counts']['w8a8_matvec'] / n:.0f} a frame")
    return dict(ms_per_frame=ab["ms_captured"], ms_eager=ab["ms_eager"],
                w8a8_per_frame=ab["counts"]["w8a8_matvec"] / n, trace=trace)


def prefill_runner(model: CSM, tokens, masks, pad_len, cap: int):
    """A call that runs one backbone prefill (`generation._prefill`) of the
    left-padded prompt (B, bucket, 33) into a cache of `cap` slots: a fresh
    write index over the same buffers at every call."""
    args, dev = model.args, model.device
    bcfg = args.backbone_config
    t, m, pad = (torch.from_numpy(a).long().to(dev)
                 for a in (tokens, masks, pad_len))
    cos_b, sin_b = rope_cache_for(
        bcfg, max(cap, bcfg.max_position_embeddings), dev)
    cache = KVCache.init(bcfg, t.shape[0], cap, dtype=model.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def run():
        fresh = KVCache(k=cache.k, v=cache.v, index=zero, length=0)
        return generation._prefill(model.params, args, t, m, pad, fresh,
                                   cos_b, sin_b)[0]
    return run


def time_prefill(model: CSM) -> None:
    """What kernel 2 does to a prefill: one CSM-1B W8A8 backbone prefill at
    B=1 of a PREFILL_ROWS prompt (left-padded to the 512- and 2048-row
    buckets, a cache of bucket + 125 slots) through kernel 2 and through
    `_prefill`'s masked branch (`CSM_TPU_FLASH_PREFILL=0`: the plain fp32
    `sdpa` over the whole cache), alternated flash, masked, masked, flash;
    device and wall ms of each (`time_ms`, 5 calls over the same cache
    slots), the kernel-2 launches, and how far the two last hidden states
    lie apart (W8A8 amplifies last-bit differences; not gated)."""
    args, dev = model.args, model.device
    bcfg = args.backbone_config
    saved = os.environ.get("CSM_TPU_FLASH_PREFILL")
    try:
        for rows in PREFILL_ROWS:
            prompt, mask = synthetic_prompt(rows, args.n_text_vocab, SEED + 3)
            tokens, masks, pad_len, bucket = generation._pad_prompt(prompt,
                                                                    mask)
            cap = bucket + 125
            run = prefill_runner(model, tokens, masks, pad_len, cap)

            runs: dict = {True: [], False: []}
            for flash in (True, False, False, True):
                os.environ["CSM_TPU_FLASH_PREFILL"] = "1" if flash else "0"
                before = attention.flash_prefill_sdpa.launches
                with torch.no_grad():
                    hidden = run().float()
                    launched = attention.flash_prefill_sdpa.launches - before
                    ms, wall = time_ms(run, reps=5, warmup=1)
                runs[flash].append((ms, wall, hidden, launched))
            n_layers = bcfg.num_hidden_layers
            for flash, want in ((True, n_layers), (False, 0)):
                if any(r[3] != want for r in runs[flash]):
                    raise AssertionError(
                        f"prefill of {rows} rows: expected {want} kernel-2 "
                        f"launches {'with' if flash else 'without'} it")
            h_k, h_p = runs[True][0][2], runs[False][0][2]
            if not bool(torch.isfinite(h_k).all() & torch.isfinite(h_p).all()):
                raise AssertionError(f"prefill of {rows} rows: not finite")
            rel = ((h_k - h_p).abs().max() / h_p.abs().max()).item()

            def fmt(rs):
                return (f"{np.mean([r[0] for r in rs]):.3f} ms device ("
                        + ", ".join(f"{r[0]:.3f}" for r in rs) + "), "
                        f"{np.mean([r[1] for r in rs]):.3f} ms wall ("
                        + ", ".join(f"{r[1]:.3f}" for r in rs) + ")")

            gemm = quant.w8a8_matvec.gemm_launches
            with torch.no_grad():
                run()
            gemm = quant.w8a8_matvec.gemm_launches - gemm
            log(f"prefill CSM-1B W8A8 B=1, {rows}-row prompt in the {bucket}"
                f"-row bucket, cache {cap}, alternated flash/masked/masked/"
                f"flash: kernel 2 {fmt(runs[True])}; masked sdpa "
                f"{fmt(runs[False])}; {n_layers} kernel-2 launches and "
                f"{gemm} kernel-1 GEMM-route launches a prefill; max |hidden "
                f"diff| / max |hidden| {rel:.3e}; before the GEMM route (H100 "
                f"80GB HBM3, 700 W): kernel 2 {PREFILL_RECORDED_MS[rows][0]} "
                f"ms, masked {PREFILL_RECORDED_MS[rows][1]} ms device")
    finally:
        if saved is None:
            os.environ.pop("CSM_TPU_FLASH_PREFILL", None)
        else:
            os.environ["CSM_TPU_FLASH_PREFILL"] = saved


def check_divergence(model: CSM, gen) -> None:
    """Kernel 3 against the dispatched decoder, teacher-forced as in
    benchmarks/resident_divergence_probe.py: random backbone hidden states
    and c0 for 4 x 16 rows; each frame's kernel-3 tokens are fed to the
    dispatched decoder (bf16, raw head), whose argmax flips where it
    disagrees. Flips are binned by the dispatched top-2 margin in units of
    the spread, the std of (plain kernel-3 - dispatched) logits on the same
    tokens. Gate: no flip at a margin of >= 4 spreads."""
    args, params = model.args, model.params
    n_cb, v = args.n_audio_codebooks, args.n_audio_vocab
    cos_d, sin_d = rope_cache_for(args.decoder_config, n_cb + 1, model.device)
    greedy = SamplerConfig(temperature=0.0)
    margins, flips, diffs = [], [], []
    for _ in range(4):
        b = 16
        hidden = torch.randn((b, args.backbone_dim), generator=gen,
                             device=model.device).to(model.dtype)
        c0 = torch.randint(0, v, (b,), generator=gen, device=model.device)
        x01 = torch.stack([hidden, embed_audio(params, args, 0, c0)
                           .to(model.dtype)], dim=1)
        proj01 = linear(params["projection"], x01)  # (B, 2, d) bf16
        proj01_t = proj01.float().transpose(0, 1).contiguous()
        toks = resident.resident_decode_frame(
            params["_resident"], args, proj01_t,
            torch.zeros((), dtype=torch.int32, device=model.device), 0.0)
        _, plain = resident.resident_decode_frame_plain(
            params["_resident"], args, proj01_t, 0.0, forced=toks.long())
        forced = toks.t().long()
        _, disp = generation.dispatched_decode(params, args, proj01, greedy,
                                               None, cos_d, sin_d,
                                               forced=forced)
        top2 = disp.topk(2, dim=-1).values
        margins.append((top2[..., 0] - top2[..., 1]).flatten())
        flips.append((disp.argmax(-1) != toks[1:].long()).flatten())
        diffs.append((plain - disp).flatten())
    margins, flips = torch.cat(margins), torch.cat(flips)
    spread = torch.cat(diffs).std().item()
    edges = [0, 0.25, 0.5, 1, 2, 4, 8, 16, float("inf")]
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (margins >= lo * spread) & (margins < hi * spread)
        bins.append((lo, hi, int(sel.sum()), int(flips[sel].sum())))
    log(f"resident vs dispatched, teacher-forced: {int(flips.sum())} flips "
        f"in {flips.numel()} picks ({flips.float().mean().item():.2%}), "
        f"spread {spread:.4f}; by margin (spreads: picks/flips) "
        + ", ".join(f"{lo:g}-{hi:g}: {n}/{f}" for lo, hi, n, f in bins))
    if any(f for lo, _, _, f in bins if lo >= 4):
        raise AssertionError("a resident-vs-dispatched flip at a margin of "
                             ">= 4 spreads")


def run_streaming(model: CSM, mimi: Mimi, frames_125: np.ndarray) -> dict:
    """`stream_generate` at full CSM-1B W8A8 width with the 32-codebook
    Mimi, greedy, STREAM_FRAMES frames from the main path's 32-row prompt
    (the text tokenizer, which the card's machine lacks, replaced by that
    prompt). Gates: the chunks, joined, within STREAM_TOL of the largest
    magnitude of `mimi.decode` of the main path's frames of the same
    prompt (fp32, TF32 off: the ring's attention sums in another order);
    one kernel-3 launch a chunk (replays counted). Then STREAM_TIMED
    streams of STREAM_TIMED_FRAMES frames each, captured and eager
    alternated: ms to the first chunk (p50, p90) and between chunks."""
    from csm_mlx_tpu_torch import tokenizers as port_tokenizers

    prompt, mask = synthetic_prompt(32, model.args.n_text_vocab, SEED)
    saved = port_tokenizers.tokenize_text_segment
    port_tokenizers.tokenize_text_segment = lambda *a: (prompt, mask)

    def stream(eager, n_chunks):
        chunks, times = [], []
        t0 = time.perf_counter()
        for chunk in generation.stream_generate(
                model, "", 0, max_audio_length_ms=STREAM_FRAMES * 80,
                temperature=0.0, mimi=mimi, _eager_step=eager):
            times.append(1e3 * (time.perf_counter() - t0))
            chunks.append(chunk)
            if len(chunks) == n_chunks:
                break
        return chunks, times

    try:
        stream(False, 3)  # the step's first frame, its capture
        reset_counts()
        chunks, _ = stream(False, STREAM_FRAMES)
        counts = read_counts()
        timed: dict = {False: [], True: []}
        for i in range(STREAM_TIMED):
            for eager in ((False, True) if i % 2 == 0 else (True, False)):
                timed[eager].append(stream(eager, STREAM_TIMED_FRAMES)[1])
    finally:
        port_tokenizers.tokenize_text_segment = saved
    wav = torch.cat(chunks)
    codes = torch.from_numpy(frames_125[:len(chunks)].T[None].copy())
    want = mimi.decode(codes.to(model.device))[0, 0].cpu()
    err = (wav - want).abs().max().item()
    tol = STREAM_TOL * want.abs().max().item()
    out = {}
    for eager, runs in timed.items():
        first = np.array([t[0] for t in runs])
        gaps = np.concatenate([np.diff(t) for t in runs])
        out["eager" if eager else "captured"] = dict(
            first_p50=float(np.percentile(first, 50)),
            first_p90=float(np.percentile(first, 90)),
            gap_ms=float(gaps.mean()), gap_p90=float(np.percentile(gaps, 90)))
    log(f"stream_generate W8A8 + Mimi(32): {len(chunks)} chunks of "
        f"{chunks[0].numel()} samples, joined vs mimi.decode of the same "
        f"frames max_abs_err {err:.3e} (tol {tol:.3e}); launches {counts}")
    log(f"stream_generate, {STREAM_TIMED} streams of {STREAM_TIMED_FRAMES} "
        f"frames each setting, alternated: " + "; ".join(
            f"{k} first chunk p50 {r['first_p50']:.2f} ms p90 "
            f"{r['first_p90']:.2f} ms, between chunks {r['gap_ms']:.2f} ms "
            f"(p90 {r['gap_p90']:.2f})" for k, r in out.items()))
    if len(chunks) != STREAM_FRAMES or not bool(torch.isfinite(wav).all()) \
            or not err <= tol:
        raise AssertionError("the streamed chunks do not match the batch "
                             "decode")
    if counts["resident_decode_frame"] != len(chunks):
        raise AssertionError("a streamed frame did not go through kernel 3")
    return out


def check_sampled_step(model: CSM) -> None:
    """T = 0.8 through the captured frame step, the caller's generator
    registered with the graph: SAMPLED_FRAMES frames from the 32-row
    prompt, each replay's kernel-3 seed and c0 read back. Gates: every
    frame draws another seed, the c0 draws vary, and every code lies in
    the vocabulary."""
    args = model.args
    gen = torch.Generator(device=model.device).manual_seed(SEED + 90)
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    step = generation.FrameStep(model, 1, bucket + SAMPLED_FRAMES + 1,
                                SamplerConfig(temperature=0.8), (), gen)
    step.first(step.prefill(tokens, masks, pad))
    seeds, c0, frames = [], [], []
    for _ in range(SAMPLED_FRAMES):
        step()
        seeds.append(int(step.seeds[0]))
        c0.append(int(step.frame[0, 0]))
        frames.append(step.frame.clone())
    frames = torch.cat(frames)
    per_replay = {f"{obj.__name__}.{attr}": n
                  for (obj, attr), n in step.captured.items()}
    log(f"sampled step T=0.8: {step.replays} replays of one graph (kernel "
        f"launches a replay {per_replay}; kernel 3's cooperative launch is "
        f"captured in it); {len(set(seeds))} distinct kernel-3 seeds and "
        f"{len(set(c0))} distinct c0 in {SAMPLED_FRAMES} frames")
    if len(set(seeds)) != SAMPLED_FRAMES or len(set(c0)) < 5 \
            or int(frames.min()) < 0 or int(frames.max()) >= args.n_audio_vocab:
        raise AssertionError("the replays repeat their draws")


def smoke_wave(seconds: float, seed: int) -> np.ndarray:
    """A voice-like test waveform at 24 kHz from numpy: five tones under a
    slow envelope, plus low noise; peak 0.5."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 24000)) / 24000.0
    x = sum(rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f * t + p)
            for f, p in zip(rng.uniform(80, 2000, 5),
                            rng.uniform(0, 2 * np.pi, 5)))
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * 0.3 * t + rng.uniform(0, 6)))
    x = x + 0.02 * rng.randn(t.size)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def rvq_disagreements(quantizer, latent, ref, other) -> tuple:
    """Where `other` codes differ from `ref` (B, K, F), on `ref`'s own RVQ
    chain over `latent` (B, D, F): the share of codes that agree, and per
    (row, frame) and half (semantic, acoustic) the first codebook where
    the two differ, with the score gap there between ref's pick and
    other's, over the largest |score| of that query (2 x.e - |e|^2 in
    fp32). The codes after a half's first difference follow another
    residual, so they differ by consequence and carry no margin of their
    own."""
    n_sem = len(quantizer["semantic"]["layers"])
    agree = float((ref == other).float().mean())
    gaps, downstream = [], 0
    for half, lo in (("semantic", 0), ("acoustic", n_sem)):
        p = quantizer[half]
        w = p["input_proj"]["weight"]
        residual = torch.einsum("bct,oc->bto", latent.float(),
                                (w[:, :, 0] if w.dim() == 3 else w).float())
        split = torch.zeros(residual.shape[:2], dtype=torch.bool,
                            device=latent.device)
        for k in range(lo, ref.shape[1] if half == "acoustic" else n_sem):
            layer = p["layers"][k - lo]
            e = codebook_embed(layer["codebook"]).float()
            scores = 2.0 * residual @ e.t() - (e * e).sum(-1)  # (B, F, V)
            r, o = ref[:, k].long(), other[:, k].long()
            first = (r != o) & ~split
            downstream += int(((r != o) & split).sum())
            if bool(first.any()):
                gap = (scores.gather(-1, r[..., None])
                       - scores.gather(-1, o[..., None]))[..., 0]
                scale = scores.abs().amax(-1)
                gaps += (gap / scale)[first].tolist()
            split |= first
            residual = residual - e[r]
    return agree, gaps, downstream


def check_codes(label: str, quantizer, latent, ref, other) -> float:
    """Gate: at least ENCODE_MIN_AGREEMENT of the codes agree, and each
    half's first difference is a near tie (a gap below ENCODE_TIE of the
    score scale), as `check_divergence` reasons about kernel 3's flips."""
    agree, gaps, downstream = rvq_disagreements(quantizer, latent, ref,
                                                other)
    log(f"{label}: {agree:.4%} of {ref.numel()} codes agree; "
        f"{len(gaps)} first differences, score gaps "
        f"{', '.join(f'{g:.2e}' for g in gaps) or 'none'} (tol "
        f"{ENCODE_TIE:g} of the score scale), {downstream} codes after them")
    if agree < ENCODE_MIN_AGREEMENT or any(g >= ENCODE_TIE for g in gaps):
        raise AssertionError(f"{label}: the codes differ beyond near ties")
    return agree


def device_busy(fn) -> tuple[float, int]:
    """(ms the card is busy, device kernels) of one call of `fn` after a
    warm-up call, from the profiler's raw device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with padded(profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])) as prof:
        fn()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return sum(e.duration_ns() for e in events) / 1e6, len(events)


def check_mimi_encode(dev, mimi: Mimi) -> dict:
    """The full-width Mimi encoder (`mimi_202407(32)`, seed SEED + 2) on a
    10 s `smoke_wave` on the card against the same parameters on the CPU
    (fp32, TF32 off): the latent before the RVQ within ENCODE_LATENT_TOL
    of its largest magnitude, the codes under `check_codes`; then
    `encode_step` frame by frame against the card's batch encode, under
    the same gate. Times a batch encode of the 10 s and one `encode_step`
    (`time_ms`), and once, as a finding and no gate, the agreement with
    cuDNN's TF32 convs (`allow_tf32 = True`, the library's default)."""
    cpu = Mimi(mimi.cfg, params=params_to_cpu(mimi.params))
    wave = smoke_wave(CONTEXT_SECONDS[0], SEED + 300)
    audio = torch.from_numpy(wave.reshape(1, 1, -1))
    frames = -(-audio.shape[-1] // mimi.frame_size)
    padded = torch.nn.functional.pad(
        audio, (0, mimi_module._bucket(frames) * mimi.frame_size
                - audio.shape[-1]))
    with torch.no_grad():
        t0 = time.perf_counter()
        want_latent = mimi_module.mimi_encode_latent(cpu.params, cpu.cfg,
                                                     padded)
        cpu_s = time.perf_counter() - t0
        latent = mimi_module.mimi_encode_latent(mimi.params, mimi.cfg,
                                                padded.to(dev)).cpu()
    rel = ((latent - want_latent).abs().max()
           / want_latent.abs().max()).item()
    log(f"Mimi encode, 10 s at 24 kHz ({frames} frames, padded to "
        f"{padded.shape[-1] // mimi.frame_size}), card vs CPU: latent max "
        f"|err| / max |latent| {rel:.3e} (tol {ENCODE_LATENT_TOL:g}); the "
        f"CPU's latent took {cpu_s:.2f} s")
    if not rel <= ENCODE_LATENT_TOL:
        raise AssertionError("card and CPU Mimi encoder latents disagree")
    want = cpu.encode(audio)
    got = mimi.encode(audio.to(dev))
    if tuple(got.shape) != (1, 32, frames):
        raise AssertionError(f"codes {tuple(got.shape)}, not (1, 32, "
                             f"{frames})")
    want_latent = want_latent[:, :, :frames]
    agree = check_codes("Mimi encode codes, card vs CPU", cpu.params[
        "quantizer"], want_latent, want, got.cpu())
    fs = mimi.frame_size
    state = mimi.init_encode_state()
    streamed = torch.cat([
        mimi.encode_step(audio[:, :, i * fs:(i + 1) * fs].to(dev), state)[0]
        for i in range(frames)], dim=-1)
    check_codes("Mimi encode_step frame by frame vs batch encode, card",
                mimi.params["quantizer"], latent[:, :, :frames].to(dev), got,
                streamed)
    audio_dev = audio.to(dev)
    encode_ms, encode_wall = time_ms(lambda: mimi.encode(audio_dev), reps=5,
                                     warmup=1)
    chunk = audio_dev[:, :, :fs]
    step_ms, step_wall = time_ms(lambda: mimi.encode_step(chunk, state))
    encode_busy = device_busy(lambda: mimi.encode(audio_dev))
    step_busy = device_busy(lambda: mimi.encode_step(chunk, state))
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32_latent = mimi_module.mimi_encode_latent(
                mimi.params, mimi.cfg, padded.to(dev)).cpu()[:, :, :frames]
        tf32 = mimi.encode(audio_dev).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    tf32_rel = ((tf32_latent - want_latent).abs().max()
                / want_latent.abs().max()).item()
    tf32_agree, tf32_gaps, _ = rvq_disagreements(cpu.params["quantizer"],
                                                 want_latent, want, tf32)
    log(f"Mimi encode timing ({card_info()}): 10 s batch encode "
        f"{encode_ms:.3f} ms device, {encode_wall:.3f} ms wall, "
        f"{encode_busy[0]:.3f} ms device busy in {encode_busy[1]} kernels "
        f"(profiler); one encode_step {step_ms:.3f} ms device, "
        f"{step_wall:.3f} ms wall, {step_busy[0]:.3f} ms busy in "
        f"{step_busy[1]} kernels (a device ms equal to the wall is the "
        f"host's issue time)")
    log(f"Mimi encode with cuDNN TF32 convs (the library's default; a "
        f"finding, not a gate): latent max |err| / max |latent| "
        f"{tf32_rel:.3e} against the CPU's; {tf32_agree:.4%} of the codes "
        f"agree with the CPU's, {len(tf32_gaps)} first differences, largest "
        f"score gap {max(tf32_gaps, default=0.0):.2e}")
    return dict(agree=agree, encode_ms=encode_ms, step_ms=step_ms,
                tf32_agree=tf32_agree, tf32_rel=tf32_rel)


def context_text_rows(text: str, n_text_vocab: int):
    """The text tokenizer's stand-in (the card's machine has no tokenizer
    files): 8-23 synthetic rows a text, seeded by the text."""
    seed = SEED + 200 + sum(map(ord, text)) % 1000
    return synthetic_prompt(8 + len(text) % 16, n_text_vocab, seed)


def context_segments() -> list:
    """The two context segments (10 s and 8 s `smoke_wave`s, speakers 0
    and 1)."""
    from csm_mlx_tpu_torch.segment import Segment

    return [Segment(0, "It rained all morning, then the sun came out.",
                    smoke_wave(CONTEXT_SECONDS[0], SEED + 300)),
            Segment(1, "We walked down to the river after lunch.",
                    smoke_wave(CONTEXT_SECONDS[1], SEED + 301))]


def run_context(model: CSM, mimi: Mimi) -> dict:
    """Voice-prompted generation at full CSM-1B width, W8A8, greedy: two
    context segments (10 s and 8 s `smoke_wave`s, speakers 0 and 1) and a
    text, the text tokenizer replaced by `context_text_rows`, so the
    prompt comes to >= 256 rows (bucket 512, kernel 2 in the prefill).
    `generate_tokens` on the assembled prompt for CONTEXT_FRAMES frames,
    captured and eager alternated (gates: equal frames; kernel 1's GEMM
    route, 16 kernel-2 launches and one kernel-3 launch a frame); the
    prefill's device ms; `stream_generate(context=...)` (gate: the chunks
    within STREAM_TOL of the batch decode of the same frames) and its
    first chunk, p50 and p90 over CONTEXT_STREAMS streams a setting,
    captured and eager alternated (the context encoded each time); then
    `generate_batch` of 4 rows with 0, 1, 2 and 2 context segments (gates:
    finite audio of the rows' lengths, equal frames captured and eager)
    and, no gate, how many rows' first frames equal their solo run."""
    args = model.args
    card = card_info()
    ctx = context_segments()
    text = "And the water was higher than I have ever seen it."
    with with_text_rows(model):
        assemble_ms = []
        for _ in range(3):  # the two context encodes and the rows
            t0 = time.perf_counter()
            prompt, mask = generation._assemble_prompt(model, text, 0, ctx,
                                                       mimi)
            assemble_ms.append(1e3 * (time.perf_counter() - t0))
        bucket = generation.prompt_bucket(prompt.shape[0])
        if prompt.shape[0] < 256 or bucket != 512:
            raise AssertionError(f"context prompt of {prompt.shape[0]} rows "
                                 f"(bucket {bucket}), not >= 256 in 512")
        ab = captured_vs_eager(
            lambda eager, n: generate_tokens(
                model, prompt, mask, n, temperature=0.0, _eager_step=eager),
            f"context prompt W8A8 ({prompt.shape[0]} rows; {card})",
            CONTEXT_FRAMES)
        frames, n = ab["frames"], int(ab["n"])
        counts = ab["counts"]
        n_layers = args.backbone_config.num_hidden_layers
        if counts["flash_prefill_sdpa"] != n_layers \
                or counts["w8a8_matvec.gemm"] < 1 \
                or counts["resident_decode_frame"] not in (n, n + 1):
            raise AssertionError(f"context prompt launches {counts}: not "
                                 f"kernel 1's GEMM route, {n_layers} kernel-2 "
                                 f"launches and one kernel 3 a frame")
        tokens, masks, pad_len, _ = generation._pad_prompt(prompt, mask)
        run = prefill_runner(model, tokens, masks, pad_len, bucket + n)
        with torch.no_grad():
            prefill_ms, prefill_wall = time_ms(run, reps=5, warmup=1)

        def stream(eager, n_chunks):
            chunks, t0 = [], time.perf_counter()
            it = generation.stream_generate(
                model, text, 0, ctx, max_audio_length_ms=CONTEXT_FRAMES * 80,
                temperature=0.0, mimi=mimi, _eager_step=eager)
            for chunk in it:
                if not chunks:
                    first = 1e3 * (time.perf_counter() - t0)
                chunks.append(chunk)
                if len(chunks) == n_chunks:
                    break
            it.close()
            return chunks, first

        reset_counts()
        chunks, _ = stream(False, CONTEXT_FRAMES)
        stream_counts = read_counts()
        wav = torch.cat(chunks)
        want = mimi.decode(torch.from_numpy(
            frames[:len(chunks)].T[None].copy()).to(model.device))[0, 0].cpu()
        err = (wav - want).abs().max().item()
        tol = STREAM_TOL * want.abs().max().item()
        firsts: dict = {False: [], True: []}
        for i in range(CONTEXT_STREAMS):
            for eager in ((False, True) if i % 2 == 0 else (True, False)):
                firsts[eager].append(stream(eager, 1)[1])
        log(f"stream_generate(context=2 segments) W8A8 + Mimi(32) ({card}): "
            f"{len(chunks)} chunks, joined vs mimi.decode of the same frames "
            f"max_abs_err {err:.3e} (tol {tol:.3e}); launches {stream_counts}")
        if len(chunks) != n or not bool(torch.isfinite(wav).all()) \
                or not err <= tol:
            raise AssertionError("the context stream does not match the "
                                 "batch decode")

        texts = ["Good morning.", "Did you see the river?",
                 "It was higher than ever.", "I saw it from the bridge."]
        contexts = [(), ctx[:1], ctx, ctx[::-1]]
        rows = [generation._assemble_prompt(model, t, i % 2, c, mimi)
                for i, (t, c) in enumerate(zip(texts, contexts))]
        ps, ms = zip(*rows)
        ab_b = captured_vs_eager(
            lambda eager, n: generate_tokens_batch(
                model, ps, ms, n, temperature=0.0, _eager_step=eager),
            f"generate_batch prompts ({', '.join(str(len(p)) for p in ps)} "
            f"rows; {card})", CONTEXT_BATCH_FRAMES, eager_runs=1)
        wavs = generation.generate_batch(
            model, texts, [0, 1, 0, 1], contexts,
            max_audio_length_ms=CONTEXT_BATCH_FRAMES * 80, temperature=0.0,
            mimi=mimi)
        lengths = [int(k) * mimi.frame_size for k in ab_b["n"]]
        solo = sum(bool(np.array_equal(
            generate_tokens(model, p, m, 1, temperature=0.0)[0][0],
            ab_b["frames"][0, i])) for i, (p, m) in enumerate(rows))
        log(f"generate_batch, 4 rows with 0/1/2/2 context segments: audio "
            f"samples {[int(w.shape[0]) for w in wavs]} (want {lengths}), "
            f"finite {all(bool(torch.isfinite(w).all()) for w in wavs)}; "
            f"first frames equal to the solo run in {solo} of 4 rows (no "
            f"gate: W8A8's activation codes amplify last-bit prefill "
            f"differences)")
        if [int(w.shape[0]) for w in wavs] != lengths \
                or not all(bool(torch.isfinite(w).all()) for w in wavs):
            raise AssertionError("generate_batch rows are not finite audio "
                                 "of their frames' lengths")
    first = {("eager" if e else "captured"): (
        float(np.percentile(v, 50)), float(np.percentile(v, 90)))
        for e, v in firsts.items()}
    log(f"voice-prompted single stream ({card}): "
        f"{ab['ms_captured']:.2f} ms a frame captured, {ab['ms_eager']:.2f} "
        f"eager; prefill of the {prompt.shape[0]}-row prompt (bucket "
        f"{bucket}) {prefill_ms:.3f} ms device, {prefill_wall:.3f} ms wall; "
        f"assembling it (18 s of context encoded) "
        f"{', '.join(f'{t:.2f}' for t in assemble_ms)} ms; "
        f"first chunk of stream_generate(context=...), encode of 18 s of "
        f"context included: " + "; ".join(
            f"{k} p50 {p50:.2f} ms p90 {p90:.2f} ms"
            for k, (p50, p90) in first.items()))
    return dict(counts=counts, rows=prompt.shape[0],
                ms_per_frame=ab["ms_captured"], ms_eager=ab["ms_eager"],
                prefill_ms=prefill_ms, first_chunk=first)


def run_batch(model: CSM) -> None:
    """65 prompts for 4 frames: two kernel-3 chunks a frame (33 + 32),
    captured against eager."""
    args = model.args
    prompts, masks = zip(*[synthetic_prompt(20 + i % 12, args.n_text_vocab,
                                            SEED + 100 + i)
                           for i in range(65)])
    ab = captured_vs_eager(
        lambda eager, n: generate_tokens_batch(
            model, prompts, masks, n, temperature=0.0, _eager_step=eager),
        "batch of 65 prompts", 4)
    frames, steps = ab["frames"], int(ab["n"].max())
    calls = ab["counts"]["resident_decode_frame"]
    log(f"batch of 65 prompts: {steps} frames, {calls} kernel-3 launches (2 "
        f"a frame), frames per row {ab['n'].min()}..{ab['n'].max()}")
    if calls != 2 * steps or frames.min() < 0 \
            or frames.max() >= args.n_audio_vocab:
        raise AssertionError("the 65-row batch did not run two chunks a frame")


def frame_step_memory(model: CSM) -> dict:
    """What the model's kept frame steps (`CSM.frame_steps`) hold on the
    card after the generation phases: each step's B, capacity and KV-cache
    bytes, and the card's allocated and reserved memory before and after
    `frame_steps.clear()` and `torch.cuda.empty_cache()`. Gate: the clear
    frees at least the caches' bytes."""
    import gc

    torch.cuda.synchronize()
    steps = list(model.frame_steps.values())
    caches = [(s.cache.k.shape[1], s.cache.capacity,
               s.cache.k.nbytes + s.cache.v.nbytes) for s in steps]
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    del steps
    model.frame_steps.clear()
    gc.collect()
    torch.cuda.empty_cache()
    after = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    mib = 1 << 20
    log(f"kept frame steps: {len(caches)} (B, capacity, KV cache MiB) "
        f"{[(b, c, round(n / mib, 1)) for b, c, n in caches]}; card memory "
        f"allocated {before[0] / mib:.0f} -> {after[0] / mib:.0f} MiB, "
        f"reserved {before[1] / mib:.0f} -> {after[1] / mib:.0f} MiB after "
        f"frame_steps.clear() and empty_cache()")
    if before[0] - after[0] < sum(n for _, _, n in caches):
        raise AssertionError("clearing the kept frame steps gave back less "
                             "than their caches")
    return dict(steps=caches, allocated=before[0] - after[0],
                reserved=before[1] - after[1])


def check_small_affine_vs_cpu(dev) -> None:
    """The affine path on a small model, 4-bit group 64, fp32, with a
    300-row prompt: the card (kernel 5 at <= 64 rows, flash prefill) against
    the CPU (plain versions). The greedy frames agree on >= 99% of the
    codes."""
    args = small_args()
    gpu = random_csm(args, torch.float32, dev, SEED + 9)
    gpu.params["audio_head"] = gpu.params["audio_head"] * 25.0
    quant.quantize_model(gpu, bits=4, group_size=64, min_size=0)
    cpu = CSM(args, params=params_to_cpu(gpu.params), dtype=torch.float32)
    prompt, mask = synthetic_prompt(300, args.n_text_vocab, SEED + 10)
    before = quant.affine_matvec.launches
    f_gpu, n_gpu = generate_tokens(gpu, prompt, mask, 4, temperature=0.0)
    launched = quant.affine_matvec.launches - before
    f_cpu, n_cpu = generate_tokens(cpu, prompt, mask, 4, temperature=0.0)
    n = min(n_gpu, n_cpu)
    agree = float((f_gpu[:n] == f_cpu[:n]).mean()) if n else 0.0
    log(f"small model affine 4-bit g64 fp32, 300-row prompt: card vs CPU "
        f"frames {n_gpu}/{n_cpu}, code agreement {agree:.4f} (need >= "
        f"0.99); {launched} kernel-5 launches on the card")
    if launched == 0 or n_gpu != n_cpu or agree < 0.99:
        raise AssertionError("card and CPU disagree on the small affine "
                             "model")


def quantized_linears(tree) -> int:
    """The number of quantized linear dicts in a params subtree."""
    if isinstance(tree, dict):
        if "weight_q" in tree:
            return 1
        return sum(quantized_linears(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(quantized_linears(v) for v in tree)
    return 0


def run_affine_path(dev, mimi: Mimi) -> dict:
    """The affine path at full CSM-1B width: random weights from SEED,
    bf16, `quantize_model(bits, group_size=64, mode="affine")`, greedy
    `generate_tokens` from the 32-row prompt (4-bit for AFFINE_FRAMES[4]
    frames and a Mimi decode, then 8-bit). Every quantized linear runs at
    <= 64 rows here, so each frame launches kernel 5 once per backbone
    linear and 31 times per decoder and projection linear (the dispatched
    decoder: a 2-row prime and 30 steps); kernels 1 and 3 never. Returns
    the 4-bit run's launch counts."""
    args = csm_1b()
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    out = {}
    for bits, n_frames in AFFINE_FRAMES.items():
        t0 = time.perf_counter()
        model = random_csm(args, torch.bfloat16, dev, SEED)
        quant.quantize_model(model, bits=bits, group_size=64, mode="affine")
        torch.cuda.synchronize()
        log(f"CSM-1B random init (seed {SEED}) + affine {bits}-bit g64: "
            f"{time.perf_counter() - t0:.1f} s")
        p = model.params
        per_frame = quantized_linears(p["backbone"]) + (
            args.n_audio_codebooks - 1) * (quantized_linears(p["decoder"])
                                           + quantized_linears(
                                               p["projection"]))

        def run(eager, n):
            return generate_tokens(model, prompt, mask, n, temperature=0.0,
                                   _eager_step=eager)

        if bits == 4:  # captured against eager, and its events a frame
            ab = captured_vs_eager(run, f"affine {bits}-bit path", n_frames,
                                   eager_runs=1)
            frames, n, counts = ab["frames"], int(ab["n"]), ab["counts"]
            ms = ab["ms_captured"]
            trace = profile_frames(model, f"trace, affine {bits}-bit path")
        else:
            run(False, n_frames)  # the step's first frame, its capture
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            frames, n = run(False, n_frames)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / max(n, 1)
            counts = read_counts()
        log(f"affine {bits}-bit path: {n} frames, {ms:.2f} ms a frame "
            f"captured; launches {counts}"
            f" = {counts['affine_matvec'] / max(n, 1):.0f} kernel-5 launches"
            f" a frame (every quantized linear: {per_frame})")
        if n != n_frames or frames.min() < 0 \
                or frames.max() >= args.n_audio_vocab:
            raise AssertionError(f"affine {bits}-bit: {n} frames or codes "
                                 f"outside the vocabulary")
        if counts["affine_matvec"] != n * per_frame \
                or counts["w8a8_matvec"] or counts["resident_decode_frame"]:
            raise AssertionError(f"affine {bits}-bit: a quantized linear "
                                 f"missed kernel 5, or kernel 1 or 3 ran")
        if bits == 4:
            codes = torch.from_numpy(frames.T[None].copy()).to(dev)
            t0 = time.perf_counter()
            audio = mimi.decode(codes)
            torch.cuda.synchronize()
            log(f"affine 4-bit: Mimi decode of {n} frames in "
                f"{time.perf_counter() - t0:.3f} s, waveform "
                f"{audio.shape[-1]} samples")
            if tuple(audio.shape) != (1, 1, n * 1920) \
                    or not bool(torch.isfinite(audio).all()):
                raise AssertionError("affine 4-bit waveform not finite")
            out = dict(counts=counts, ms_per_frame=ms,
                       ms_eager=ab["ms_eager"], trace=trace)
        del model, run
        torch.cuda.empty_cache()
    return out


def batch_inputs(args, n_rows: int):
    """n_rows prompts of 20-31 rows and their masks: each row gets its own
    pad in the 32-row bucket."""
    prompts, masks = zip(*[synthetic_prompt(20 + i % 12, args.n_text_vocab,
                                            SEED + 200 + i)
                           for i in range(n_rows)])
    return prompts, masks


def check_decode_step(args, dev, gen, prompts, masks) -> dict:
    """One backbone step of the batch on the same cache state (after the
    prompts' prefill, a random frame as input), its attention through
    kernel 4 (`flash_decode_min_b=8`) and through the masked sdpa (None),
    on an unquantized CSM-1B (random weights) in bf16 and in fp32. Returns
    by type max |hidden err| / max |hidden| (the gated ratio) and the ratio
    of the two's norms. Unquantized, because on a W8A8 model any last-bit
    change of the attention output moves int8 activation codes, and 16
    layers amplify that to the quantization noise (PERF.md §6)."""
    bcfg = args.backbone_config
    b, bucket = len(prompts), 32
    tokens = torch.zeros((b, bucket, 33), dtype=torch.long, device=dev)
    mask = torch.zeros_like(tokens)
    pad = torch.zeros((b,), dtype=torch.long, device=dev)
    for i, (p, m) in enumerate(zip(prompts, masks)):
        pad[i] = bucket - p.shape[0]
        tokens[i, bucket - p.shape[0]:] = torch.from_numpy(p)
        mask[i, bucket - p.shape[0]:] = torch.from_numpy(m)
    cap = bucket + BATCH_FRAMES
    cos_b, sin_b = rope_cache_for(bcfg, max(cap, bcfg.max_position_embeddings),
                                  dev)
    frame = torch.randint(0, args.n_audio_vocab, (b, 32), generator=gen,
                          device=dev)
    tok, msk = generation._frame_to_next_input(frame)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        m = random_csm(args, dtype, dev, SEED + 41)
        with torch.no_grad():
            cache = KVCache.init(bcfg, b, cap, dtype=dtype, device=dev)
            _, cache = generation._prefill(m.params, args, tokens, mask, pad,
                                           cache, cos_b, sin_b)

            def step(min_b):
                c = KVCache(k=cache.k.clone(), v=cache.v.clone(),
                            index=cache.index, length=cache.length)
                h, _ = generation._backbone_step(m.params, args, tok, msk,
                                                 pad, c, cos_b, sin_b, min_b)
                return h.float()

            kernel, plain = step(8), step(None)
        diff = kernel - plain
        out[dtype] = ((diff.abs().max() / plain.abs().max()).item(),
                      (diff.norm() / plain.norm()).item())
        del m, cache
        torch.cuda.empty_cache()
    return out


def flash_decode_ab(run, min_b: int) -> dict:
    """`run(flash_decode_min_b, n_frames)` -> (frames (F, B, 32), n (B,))
    with kernel 4 (`min_b`) and without (None): a 2-frame warm-up of each,
    then BATCH_FRAMES frames in the order on, off, off, on, so that host
    drift falls on both settings alike. Each run's launch counts are set to
    0 just before it and read just after. Returns, by setting, the frames,
    n and counts of its first run and the seconds of both."""
    for setting in (min_b, None):  # the captured step of each, captured
        run(setting, BATCH_FRAMES)
    out = {}
    for setting in (min_b, None, None, min_b):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        frames, n = run(setting, BATCH_FRAMES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        if setting in out:
            out[setting]["seconds"].append(dt)
        else:
            out[setting] = dict(frames=frames, n=n, counts=counts,
                                seconds=[dt])
    return out


def run_batch_flash_decode(model: CSM, gen) -> dict:
    """Kernel 4 on the W8A8 model (the decoder one kernel-3 launch a
    frame), each case with and without it (`flash_decode_ab`): BATCH_ROWS
    prompts of 20-31 rows through `generate_tokens_batch` with
    `flash_decode_min_b=8` (kernel 4 in each of the 16 layers of every
    backbone step), the first 8 of them likewise, and the 32-row prompt
    through `generate_tokens` with `flash_decode_min_b=1`. Gates: 16
    kernel-4 launches a step with it and none without, every frame made,
    codes in range; and one step on the same cache state within STEP_TOL
    of the masked sdpa (`check_decode_step`). Returns the BATCH_ROWS run's
    launch counts."""
    args = model.args
    n_layers = args.backbone_config.num_hidden_layers
    prompts, masks = batch_inputs(args, BATCH_ROWS)
    one, one_mask = synthetic_prompt(32, args.n_text_vocab, SEED)

    def batch(n_rows):
        return lambda min_b, n: generate_tokens_batch(
            model, prompts[:n_rows], masks[:n_rows], n, temperature=0.0,
            flash_decode_min_b=min_b)

    def single(min_b, n):
        frames, n_made = generate_tokens(model, one, one_mask, n,
                                         temperature=0.0,
                                         flash_decode_min_b=min_b)
        return frames[:, None], np.array([n_made])

    steps = BATCH_FRAMES - 1
    out = None
    for label, run, min_b in ((f"batch of {BATCH_ROWS}", batch(BATCH_ROWS), 8),
                              ("batch of 8", batch(8), 8),
                              ("single stream", single, 1)):
        ab = flash_decode_ab(run, min_b)
        on, off = ab[min_b], ab[None]
        launched = on["counts"]["flash_decode_sdpa"]
        same = on["frames"].shape == off["frames"].shape
        agree = float((on["frames"] == off["frames"]).mean()) if same else 0.
        ms = {k: [1e3 * s / BATCH_FRAMES for s in r["seconds"]]
              for k, r in (("on", on), ("off", off))}
        log(f"{label}, {BATCH_FRAMES} frames, alternated on/off/off/on: "
            f"flash decode {np.mean(ms['on']):.2f} ms per frame "
            f"({', '.join(f'{t:.2f}' for t in ms['on'])}), masked sdpa "
            f"{np.mean(ms['off']):.2f} "
            f"({', '.join(f'{t:.2f}' for t in ms['off'])}); {launched} "
            f"kernel-4 launches ({launched / steps:.0f} a step), launches "
            f"{on['counts']}; code agreement of the two settings {agree:.4f}; "
            f"before kernel 3's redesign (H100 80GB HBM3, 700 W): "
            f"{FRAME_RECORDED_MS[label][0]} / {FRAME_RECORDED_MS[label][1]} "
            f"ms per frame")
        for r in (on, off):
            if int(r["n"].max()) != BATCH_FRAMES or r["frames"].min() < 0 \
                    or r["frames"].max() >= args.n_audio_vocab:
                raise AssertionError(f"{label}: the run stopped early or "
                                     f"made codes outside the vocabulary")
        if launched != n_layers * steps or off["counts"]["flash_decode_sdpa"]:
            raise AssertionError(f"{label}: expected {n_layers} kernel-4 "
                                 f"launches a step with flash_decode_min_b="
                                 f"{min_b} and none without")
        if out is None:
            out = dict(counts=on["counts"])
    rel = check_decode_step(args, model.device, gen, prompts, masks)
    for dtype, (r, r_norm) in rel.items():
        log(f"one backbone step on the same cache, unquantized CSM-1B "
            f"{str(dtype)}: max |hidden err| / max |hidden|, kernel 4 vs "
            f"masked sdpa {r:.3e} (tol {STEP_TOL[dtype]:g}); |err| / "
            f"|hidden| in norm {r_norm:.3e}")
    if any(r[0] > STEP_TOL[dtype] for dtype, r in rel.items()):
        raise AssertionError("kernel 4 moved the backbone step's hidden "
                             "state past its tolerance")
    return out


def flash_train_inputs(gen, dev, dtype, b, s):
    """q, k, v as the backbone makes them (transposed (B, S, heads, 64)
    projections), and a random dO."""
    h, n_kv = 32, 8

    def proj(heads):
        return torch.randn((b, s, heads, 64), generator=gen,
                           device=dev).to(dtype).transpose(1, 2)

    return proj(h), proj(n_kv), proj(n_kv), proj(h)


def time_sdpa_train(q, k, v, do, scale) -> tuple[float, float, float]:
    """Device ms of `F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)` on the same inputs: forward, backward alone, forward
    + backward. Timed here only, as the library-call column; the port never
    calls it."""
    import torch.nn.functional as F

    def fwd(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                              scale=scale, enable_gqa=True)

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fwd(qg, kg, vg)
    ms_f = time_ms(lambda: fwd(q, k, v))[0]
    ms_b = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True))[0]

    def both():
        o = fwd(qg, kg, vg)
        torch.autograd.grad(o, (qg, kg, vg), do)

    return ms_f, ms_b, time_ms(both)[0]


def flash_train_bounds(q, k, dtype) -> dict:
    """Kernels 6 and 7's bounds: causal FLOPs 2*B*H*S^2*D forward and 2.5x
    that backward, at the peak of the input type, against the bytes each
    moves (inputs read once, outputs written once)."""
    b, h, s, d = q.shape
    kind = "bf16" if dtype == torch.bfloat16 else "fp32"
    e = torch.empty((), dtype=dtype).element_size()
    qb, kb = b * h * s * d * e, k.numel() * e
    lse = b * h * s * 4
    flops = 2.0 * b * h * s * s * d
    return dict(fwd=bound_ms(2 * qb + 2 * kb + lse, flops, kind),
                bwd=bound_ms(4 * qb + 4 * kb + lse, 2.5 * flops, kind))


def launch_split(fn, per_call: int, reps: int = 5) -> str:
    """torch.profiler over `reps` calls of fn (warm), each of `per_call`
    kernel launches: the mean device us of each kernel, by name, largest
    first, and how many of the reps * per_call launches the profiler kept;
    beside it the device us of a call from CUDA events (`time_ms`), which
    count every launch: for a one-launch call, that launch's time.
    Events accumulate across the session (`acc_events`) and the card
    synchronizes after every call. (Late in this script the profiler has
    kept as few as none of 5 kernel-6 launches and 9 of 15 kernel-7 ones,
    where a fresh process kept all, padded or not: the CUDA-event time
    counts every launch.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    kept = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0][:48]
            n, us = by_name.get(name, (0, 0))
            by_name[name] = (n + 1, us + e.time_range.elapsed_us())
            kept += 1
    call_us = 1e3 * time_ms(fn, reps=reps)[0]
    return (f"a call {call_us:.1f} us by CUDA events; profiler: {kept} of "
            f"{reps * per_call} launches kept" + "".join(
                f"; {k} {us / n:.1f} us x{n}" for k, (n, us) in
                sorted(by_name.items(), key=lambda kv: -kv[1][1])))


def check_flash_train(dev, gen) -> dict:
    """Kernels 6 and 7 against their plain versions at the backbone's
    shape, with random dO: max_abs_err and max |err| / max |plain| of O,
    dq, dk and dv within FLASH_TRAIN_TOL, the logsumexp within
    FLASH_TRAIN_LSE_TOL, and a second call of each bit-equal to the first;
    device times of the kernels, the plain versions and the library call,
    the bound, the kernels' share of it and their ratio to the library;
    in bf16, the profiler's split of each kernel by launch. Returns the
    JSON entries' numbers at the training path's case, (B=2, S=575) bf16."""
    scale = 64 ** -0.5
    out = {}
    for b, s in FLASH_TRAIN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_train_inputs(gen, dev, dtype, b, s)
            o, lse = flash_train.flash_train_fwd(q, k, v, scale)
            grads = flash_train.flash_train_bwd(q, k, v, o, lse, do, scale)
            o2, lse2 = flash_train.flash_train_fwd(q, k, v, scale)
            grads2 = flash_train.flash_train_bwd(q, k, v, o, lse, do, scale)
            want_o, want_lse = flash_train.flash_train_fwd_plain(q, k, v,
                                                                 scale)
            want = flash_train.flash_train_bwd_plain(q, k, v, do, scale)
            torch.cuda.synchronize()
            repeat_equal = torch.equal(o, o2) and torch.equal(lse, lse2) \
                and all(torch.equal(x, y) for x, y in zip(grads, grads2))
            errs = {}
            for name, got, ref in zip(("O", "dq", "dk", "dv"),
                                      (o, *grads), (want_o, *want)):
                ref = ref.float()
                abs_err = (got.float() - ref).abs().max().item()
                if not bool(torch.isfinite(got).all()):
                    abs_err = float("inf")
                errs[name] = (abs_err, abs_err / ref.abs().max().item())
            lse_err = (lse - want_lse).abs().max().item()
            tol = FLASH_TRAIN_TOL[dtype]
            ok = all(rel <= tol for _, rel in errs.values()) \
                and lse_err <= FLASH_TRAIN_LSE_TOL
            ms_f = time_ms(lambda: flash_train.flash_train_fwd(q, k, v, scale),
                           reps=10)[0]
            ms_b = time_ms(lambda: flash_train.flash_train_bwd(
                q, k, v, o, lse, do, scale), reps=10)[0]
            pl_f = time_ms(lambda: flash_train.flash_train_fwd_plain(
                q, k, v, scale), reps=5, warmup=1)[0]
            pl_b = time_ms(lambda: flash_train.flash_train_bwd_plain(
                q, k, v, do, scale), reps=5, warmup=1)[0]
            lib_f, lib_b, lib_fb = time_sdpa_train(q, k, v, do, scale)
            bounds = flash_train_bounds(q, k, dtype)
            log(f"flash_train B={b} S={s} {str(dtype):14s} "
                f"({FLASH_TRAIN_ROUTE[dtype]}) "
                + "  ".join(f"{n} max_abs_err {a:.3e} rel {r:.3e}"
                            for n, (a, r) in errs.items())
                + f" (tol rel {tol:g})  lse max_abs_err {lse_err:.3e} (tol "
                f"{FLASH_TRAIN_LSE_TOL:g})  repeat bit-equal {repeat_equal}"
                f"  kernel fwd {ms_f:.4f} bwd {ms_b:.4f}"
                f" ms device  plain fwd {pl_f:.4f} bwd {pl_b:.4f}  sdpa fwd "
                f"{lib_f:.4f} bwd {lib_b:.4f} fwd+bwd {lib_fb:.4f}  bound fwd "
                f"{bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}) bwd "
                f"{bounds['bwd'][0]:.4f} ({bounds['bwd'][1]}) = "
                f"{bounds['fwd'][0] / ms_f:.1%} / {bounds['bwd'][0] / ms_b:.1%}"
                f" of the kernels; kernel / sdpa fwd {ms_f / lib_f:.2f}x bwd "
                f"{ms_b / lib_b:.2f}x"
                + (" (recorded: fwd {:.1f} bwd {:.1f} us)".format(
                    *FLASH_TRAIN_RECORDED_US[(b, s)])
                   if dtype == torch.bfloat16 else "")
                + f"  {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"flash_train kernels disagree at B={b} "
                                     f"S={s} {dtype}")
            if not repeat_equal:
                raise AssertionError(f"flash_train kernels gave other bits on "
                                     f"a second call at B={b} S={s} {dtype}")
            if dtype == torch.bfloat16:
                split_f = launch_split(
                    lambda: flash_train.flash_train_fwd(q, k, v, scale), 1)
                split_b = launch_split(lambda: flash_train.flash_train_bwd(
                    q, k, v, o, lse, do, scale), 3)
                log(f"flash_train B={b} S={s} bf16 by launch: fwd {split_f}"
                    f"  bwd {split_b}")
            if (b, s, dtype) == (2, 575, torch.bfloat16):
                for key, ms, pl, lib, bd in (
                        ("fwd", ms_f, pl_f, lib_f, bounds["fwd"]),
                        ("bwd", ms_b, pl_b, lib_b, bounds["bwd"])):
                    err = errs["O"][0] if key == "fwd" else \
                        max(errs[n][0] for n in ("dq", "dk", "dv"))
                    out[key] = dict(max_abs_err=err, ms=ms, plain_ms=pl,
                                    bound_ms=bd[0], bound_by=bd[1],
                                    library_ms=lib)
            del q, k, v, do, o, lse, grads, o2, lse2, grads2, want_o, want
            torch.cuda.empty_cache()
    return out


def train_batch(args, b: int, s: int, seed: int) -> dict:
    """benchmarks/train_bench.py's synthetic batch: random codes in every
    slot, all masks 1."""
    rng = np.random.RandomState(seed)
    k = args.n_audio_codebooks + 1
    return {"tokens": rng.randint(0, args.n_audio_vocab,
                                  size=(b, s, k)).astype(np.int32),
            "masks": np.ones((b, s, k), dtype=np.int32),
            "loss_masks": np.ones((b, s, k), dtype=np.int32)}


class SyntheticItems(CSMDataset):
    """Pre-tokenized items of `frames` frames (the Mimi encoder is not
    ported): `get_batch` pads them to the 64-bucket as the dataset does."""

    def __init__(self, args, n: int, frames: int, seed: int):
        super().__init__([])
        one = train_batch(args, n, frames, seed)
        self.items = [tuple(one[f][i] for f in ("tokens", "masks",
                                                "loss_masks"))
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


def reset_flash_counts() -> None:
    flash_train.flash_train_fwd.launches = 0
    flash_train.flash_train_bwd.launches = 0


def flash_counts() -> tuple[int, int]:
    return (flash_train.flash_train_fwd.launches,
            flash_train.flash_train_bwd.launches)


def timed_steps(trainer, batch, n: int) -> tuple[list, list]:
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch))  # float(): synchronizes
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms


def trace_step(trainer, batch, label: str) -> None:
    """torch.profiler over one more training step: the card's busy time
    (the profiler slows the host, so the busy share reads low), device
    events, the share of the busy time in kernels 6 and 7 (every kernel of
    csrc/flash_train.cu), and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with padded(profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name[:56], (0, 0))
            by_name[e.name[:56]] = (n + 1, us + e.time_range.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    flash_ms = sum(us for k, (_, us) in by_name.items()
                   if any(n in k for n in FLASH_TRAIN_KERNELS)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"trace, one {label} step: "
        f"{sum(n for n, _ in by_name.values())} device events, device busy "
        f"{busy_ms:.1f} ms of {wall_ms:.1f} ms profiled wall; kernels 6 and "
        f"7 {flash_ms:.2f} ms = {flash_ms / busy_ms:.1%} of busy; top: "
        + "; ".join(f"{k} {us / 1e3:.2f} ms x{n}" for k, (n, us) in top))


def run_training(dev, workdir: str) -> dict:
    """The fine-tuning path at full CSM-1B width and depth, bf16, random
    weights: (a) full SFT with remat, AdamW at the CLI's defaults, five
    steps on one (B=2, S=576) batch; (c) one DPO and one KTO step (KTO
    against a copy of the policy: exactly 0.5); (b) LoRA rank 8 on the
    default keys, dropout 0.05, three steps, base weights bit-equal (each
    of (a) and (b) then traces one more step); (d)
    train() over 4 items of 575 frames with ckpt_freq=1, then a new trainer
    on the directory resumes step, epoch, adapters and optimizer state
    bit-equal; (e) every step launches kernel 6 32 times (remat) and kernel
    7 16 times; (f) the asynchronous checkpoints (`async_checkpoints`).
    Returns the kernels' launches over the whole phase."""
    args = csm_1b()
    n_layers = args.backbone_config.num_hidden_layers
    model = random_csm(args, torch.bfloat16, dev, SEED + 20)
    batch = train_batch(args, TRAIN_B, TRAIN_S, SEED + 21)
    frames = TRAIN_B * TRAIN_S
    reset_flash_counts()
    common = dict(ckpt_freq=0, gradient_checkpointing=True,
                  learning_rate=1e-5)

    def optimizer():
        return ft.build_optimizer("adamw", 1e-5, 1e-4)

    # (a) full SFT
    torch.cuda.reset_peak_memory_stats()
    sft = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                     output_dir=f"{workdir}/sft", **common))
    before = flash_counts()
    losses, ms = timed_steps(sft, batch, 5)
    fwd, bwd = (a - b for a, b in zip(flash_counts(), before))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = float(np.median(ms[1:]))
    log(f"(a) full SFT CSM-1B bf16 B={TRAIN_B} S={TRAIN_S} remat, AdamW "
        f"lr 1e-5 wd 1e-4: losses " + ", ".join(f"{x:.5f}" for x in losses)
        + f"; ms per step " + ", ".join(f"{x:.1f}" for x in ms)
        + f" (median of steps 2-5 {steady:.1f} ms = {frames / steady * 1e3:.0f}"
        f" frames/s); peak memory {peak:.2f} GiB")
    log(f"(e) flash launches over 5 SFT steps: kernel 6 {fwd} "
        f"({fwd / 5:.0f} a step), kernel 7 {bwd} ({bwd / 5:.0f} a step)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"full SFT loss did not fall: {losses}")
    if (fwd, bwd) != (5 * 2 * n_layers, 5 * n_layers):
        raise AssertionError(f"expected {2 * n_layers} kernel-6 and "
                             f"{n_layers} kernel-7 launches a step")
    trace_step(sft, batch, "full SFT")
    del sft
    torch.cuda.empty_cache()

    # (c) DPO and KTO, one step each
    dpo = ft.DPOTrainer(ft.DPOArgs(model=model, optimizer=optimizer(),
                                   output_dir=f"{workdir}/dpo", **common))
    rejected = train_batch(args, TRAIN_B, TRAIN_S, SEED + 22)
    pair = {f"chosen_{k}": v for k, v in batch.items()}
    pair.update({f"rejected_{k}": v for k, v in rejected.items()})
    dpo_loss, dpo_ms = timed_steps(dpo, pair, 1)
    del dpo
    torch.cuda.empty_cache()
    reference = CSM(args, params=map_params(
        lambda t: t.detach().clone(), model.params), dtype=torch.bfloat16)
    kto = ft.KTOTrainer(ft.KTOArgs(model=model, optimizer=optimizer(),
                                   output_dir=f"{workdir}/kto",
                                   reference_model=reference, **common))
    kto_batch = dict(batch, preferences=np.asarray([1, -1], dtype=np.int32))
    kto_loss, kto_ms = timed_steps(kto, kto_batch, 1)
    log(f"(c) DPO step: loss {dpo_loss[0]:.6f} ({dpo_ms[0]:.1f} ms); KTO "
        f"step against a copy of the policy: loss {kto_loss[0]!r} (must be "
        f"0.5 exactly; {kto_ms[0]:.1f} ms)")
    if not np.isfinite(dpo_loss[0]) or kto_loss[0] != 0.5:
        raise AssertionError("DPO loss not finite or KTO step-0 loss not 0.5")
    del kto, reference
    torch.cuda.empty_cache()

    # (b) LoRA rank 8 on the default keys
    lora.linear_to_lora_layers(model, {"rank": 8, "scale": 2.0,
                                       "dropout": 0.05, "seed": SEED})
    lora_args = dict(common, trainable_filter=lora.trainable_filter)
    base = {k: v.clone() for k, v in tree_to_flat(model.params).items()
            if not lora.trainable_filter(k)}
    adapters = {k: v.clone() for k, v in tree_to_flat(model.params).items()
                if lora.trainable_filter(k)}
    torch.cuda.reset_peak_memory_stats()
    tuner = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                       output_dir=f"{workdir}/lora",
                                       **lora_args))
    losses, ms = timed_steps(tuner, batch, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trace_step(tuner, batch, "LoRA")
    flat = tree_to_flat(model.params)
    base_equal = all(torch.equal(flat[k], v) for k, v in base.items())
    moved = sum(not torch.equal(flat[k], v) for k, v in adapters.items())
    log(f"(b) LoRA rank 8, default keys, dropout 0.05: {len(adapters)} "
        f"adapter tensors, {len(tuner.trainable)} trainable; losses "
        + ", ".join(f"{x:.5f}" for x in losses) + "; ms per step "
        + ", ".join(f"{x:.1f}" for x in ms) + f"; peak memory {peak:.2f} GiB;"
        f" base weights bit-equal {base_equal}, adapters moved {moved}")
    if not base_equal or moved == 0 or not all(np.isfinite(losses)):
        raise AssertionError("LoRA steps moved a base weight or no adapter")
    del tuner, base
    torch.cuda.empty_cache()

    # (d) train() with checkpoints, then resume
    run_dir = f"{workdir}/resume"
    ckpt_args = dict(lora_args, ckpt_freq=1, only_save_trainable_params=True)
    items = SyntheticItems(args, 4, TRAIN_S - 1, SEED + 23)
    t1 = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                    output_dir=run_dir, **ckpt_args))
    t0 = time.perf_counter()
    t1.train(items, batch_size=2, epochs=1)
    t_train = time.perf_counter() - t0
    saved = {n: t.detach().clone() for n, t in t1.trainable}
    opt_saved = {n: {k: v.clone() for k, v in t1.optimizer.state[t].items()}
                 for n, t in t1.trainable}
    with torch.no_grad():
        for _, t in t1.trainable:
            t.zero_()
    t2 = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                    output_dir=run_dir, **ckpt_args))
    flat = tree_to_flat(model.params)
    weights_equal = all(torch.equal(flat[n], v) for n, v in saved.items())
    opt_equal = all(torch.equal(t2.optimizer.state[t][k].to(v.device), v)
                    for n, t in t2.trainable
                    for k, v in opt_saved[n].items())
    log(f"(d) train() over 4 items of {TRAIN_S - 1} frames, batch 2, "
        f"ckpt_freq 1: {t1.state.step} steps in {t_train:.2f} s (3 saves); a "
        f"new trainer resumed step {t2.state.step}, epoch {t2.state.epoch}, "
        f"adapters bit-equal {weights_equal}, optimizer state bit-equal "
        f"{opt_equal}")
    if (t2.state.step, t2.state.epoch) != (2, 1) or not weights_equal \
            or not opt_equal:
        raise AssertionError("resume did not restore step, epoch, adapters "
                             "and optimizer state")
    del t1, t2, model
    torch.cuda.empty_cache()

    async_ckpt = async_checkpoints(args, batch, common, optimizer, workdir)
    return dict(launches=flash_counts(), steady_ms=steady, frames_per_s=frames
                / steady * 1e3, async_ckpt=async_ckpt)


def check_training_vs_plain(dev) -> None:
    """One step's loss and per-leaf gradient norms through kernels 6 and 7
    and through the masked sdpa (flash_min_len=0), on CSM-1B at full width
    with a 2-layer backbone, fp32, B=2, S=576: the loss within 1e-5 and
    every leaf's gradient norm within 1e-3 (relative; sum order only). Then
    the peak memory of one step at (B=1, S=2048) both ways."""
    port_config.BACKBONE_CONFIGURATION["1b_2l"] = dataclass_replace(
        port_config.BACKBONE_CONFIGURATION["1b"], num_hidden_layers=2)
    base = csm_1b()
    args = ModelArgs("1b_2l", base.decoder_name, base.n_text_vocab,
                     base.n_audio_vocab, base.n_audio_codebooks)
    model = random_csm(args, torch.float32, dev, SEED + 30)
    flat = tree_to_flat(model.params)
    for t in flat.values():
        t.requires_grad_(True)

    def step(b, s, min_len):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in train_batch(args, b, s, SEED + 31).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = compute_loss(model.params, args, batch, remat=False,
                            flash_min_len=min_len)
        grads = torch.autograd.grad(loss, list(flat.values()))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        norms = [g.float().norm().item() for g in grads]
        return loss.item(), norms, peak

    before = flash_counts()
    l_k, n_k, _ = step(TRAIN_B, TRAIN_S, 512)
    if flash_counts() == before:
        raise AssertionError("the kernel step did not launch kernels 6 and 7")
    l_p, n_p, _ = step(TRAIN_B, TRAIN_S, 0)
    loss_rel = abs(l_k - l_p) / abs(l_p)
    norm_rel = max(abs(a - b) / max(b, 1e-30) for a, b in zip(n_k, n_p)
                   if b > 0)
    _, _, peak_k = step(1, 2048, 512)
    _, _, peak_p = step(1, 2048, 0)
    log(f"training step, kernels vs masked sdpa (CSM-1B width, 2-layer "
        f"backbone, fp32, B={TRAIN_B} S={TRAIN_S}): loss {l_k:.6f} vs "
        f"{l_p:.6f}, rel err {loss_rel:.2e} (tol 1e-5); {len(n_k)} gradient "
        f"leaves, worst norm rel err {norm_rel:.2e} (tol 1e-3); peak memory "
        f"of a step at B=1 S=2048: {peak_k:.2f} GiB with the kernels, "
        f"{peak_p:.2f} GiB with the masked sdpa")
    for t in flat.values():
        t.requires_grad_(False)
    if not loss_rel <= 1e-5 or not norm_rel <= 1e-3:
        raise AssertionError("the training step through kernels 6 and 7 "
                             "disagrees with the masked sdpa")


# --- parallel fine-tuning: meshes, DP and FSDP, ring attention, pipeline ----


def par_trainer(args, dev, out_dir: str, mesh=None,
                sharding: str = "replicated"):
    """A full-SFT trainer (remat, AdamW PAR_LR / 1e-4, clipping at 1) on a
    fresh CSM-1B bf16 of the phase's seed: every rank and every mode
    starts from the same parameters. Its `held` is the memory allocated
    before it was made, which its peak leaves out."""
    held = torch.cuda.memory_allocated(dev)
    model = random_csm(args, torch.bfloat16, dev, SEED + 90)
    return ft.CSMTrainer(ft.TrainArgs(
        model=model, optimizer=ft.build_optimizer("adamw", PAR_LR, 1e-4),
        output_dir=out_dir, ckpt_freq=0, gradient_checkpointing=True,
        learning_rate=PAR_LR, mesh=mesh, param_sharding=sharding)), held


def par_steps(tr, held: int, batch) -> dict:
    """PAR_STEPS steps: losses, ms a step, kernels 6 and 7 launches a step,
    the peak above `held` (the trainer's model, optimizer state and step;
    not what was allocated before the trainer was made), and the bytes the
    rank stores for the parameters and the AdamW state (its shards under
    FSDP)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = flash_counts()
    losses, ms = timed_steps(tr, batch, PAR_STEPS)
    launches = [(a - b) / PAR_STEPS for a, b in zip(flash_counts(), before)]
    stored = sum(t.nbytes for t in tree_to_flat(tr.model.params).values()) \
        + sum(v.nbytes for st in tr.optimizer.state.values()
              for v in st.values() if torch.is_tensor(v))
    return dict(losses=losses, ms=ms, launches=launches,
                peak=(torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                stored=stored / 2 ** 30)


def update_errors(params, ref, init) -> tuple:
    """How far the update params - init is from the reference update
    ref - init, as ||got - want|| / ||want||: over every leaf together,
    and the worst weight matrix (ndim >= 2) with its name. 1-D leaves (the
    norms, ~1.0: ulp 7.8e-3) barely move at PAR_LR; they count in the
    whole only."""
    got, want, before = (tree_to_flat(t) for t in (params, ref, init))
    num = den = worst = 0.0
    worst_name = ""
    for name, w0 in before.items():
        d_want = want[name].detach().float() - w0.float()
        diff = float((got[name].detach().float()
                      - want[name].detach().float()).norm()) ** 2
        size = float(d_want.norm()) ** 2
        num, den = num + diff, den + size
        if w0.dim() >= 2 and (diff / max(size, 1e-30)) ** 0.5 > worst:
            worst, worst_name = (diff / max(size, 1e-30)) ** 0.5, name
    return (num / den) ** 0.5, worst, worst_name


def ring_check(mesh, dev, dtype) -> dict:
    """ring_sdpa on this rank's blocks of a (1, 32, 2048, 64) causal
    attention (8 kv heads) against the plain causal attention (fp32 sdpa
    on the same inputs), forward and backward of sum(o ** 2): each largest
    error over the largest magnitude, and ms of the ring's forward and
    backward."""
    b, h, s, hkv, d = RING_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 95)
    q, k, v = (torch.randn(b, heads, s, d, generator=gen, device=dev)
               .to(dtype) for heads in (h, hkv, hkv))
    scale = d ** -0.5
    blocks = [parallel.shard_sequence(t, mesh).detach().requires_grad_(True)
              for t in (q, k, v)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = parallel.ring_sdpa(*blocks, scale, mesh)
    (o.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    full = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    ref = attention.sdpa(*full, scale, attention.causal_mask_bias(
        s, s, device=dev)[None, None])
    (ref ** 2).sum().backward()

    def rel(got, want):
        want = parallel.shard_sequence(want.detach(), mesh)
        return ((got.float() - want).abs().max()
                / want.abs().max()).item()

    return dict(fwd=rel(o, ref), grads=[rel(g.grad, w.grad) for g, w in
                                        zip(blocks, full)], ms=ms)


def pipeline_check(mesh, dev, model) -> dict:
    """pipeline_forward over the CSM-1B backbone's 16 layers (bf16, the
    mesh's stages, PIPE_MICRO microbatches of PIPE_B rows of S - 1 = 575)
    against llama_forward: the largest error over the largest magnitude,
    and the pipeline's ms."""
    cfg = model.args.backbone_config
    s = TRAIN_S - 1
    n_stages = parallel.mesh.axis_sizes(mesh)["pipe"]
    stacked = parallel.shard_pipeline_params(parallel.stack_pipeline_params(
        model.params["backbone"]["layers"], n_stages), mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 96)
    x = torch.randn(PIPE_B, s, cfg.hidden_size, generator=gen,
                    device=dev).to(torch.bfloat16)
    cos, sin = rope_cache_for(cfg, s, dev)
    pos = torch.arange(s, device=dev)[None]
    bias = attention.causal_mask_bias(s, s, device=dev)[None, None]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = parallel.pipeline_forward(
            stacked, cfg, x, cos, sin, pos, bias, mesh, PIPE_MICRO,
            norm=model.params["backbone"]["norm"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want, _ = llama_forward(model.params["backbone"], cfg, x, cos, sin,
                                pos, bias, None)
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    return dict(err=err, ms=ms, stages=n_stages,
                layers=cfg.num_hidden_layers)


def gloo_p2p_probe(workdir: str) -> dict:
    """Two processes on cuda:0 over gloo try one `batch_isend_irecv` of a
    CUDA tensor (the ring's and the pipeline's collective; `send`/`recv`
    take the same path): their exit codes and gloo's error lines."""
    store = f"{workdir}/p2p-store"
    procs = [subprocess.Popen([sys.executable, "-c", P2P_PROBE, str(r),
                               store], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    errors = sorted({line.strip() for _, err in outs
                     for line in err.splitlines()
                     if "gloo" in line or "Connection closed" in line})
    return dict(ok=all(p.returncode == 0 and "received" in out
                       for p, (out, _) in zip(procs, outs)),
                codes=[p.returncode for p in procs], errors=errors)


def parallel_rank(rank: int, n: int, store: str, payload: dict,
                  results) -> None:
    """One of (b)'s ranks: cuda:0, a gloo group, the kernels the parent
    built; the mesh-less steps as the reference, a control (the mesh-less
    trainer on this rank's row only: the steps without the gradient
    reduce), then PAR_STEPS replicated and FSDP steps on the rank's row of
    the batch; each run's `update_errors` against the reference. Reports
    to `results`; a failure reports its traceback."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        dev = torch.device(payload["device"])
        torch.cuda.set_device(dev)
        lib_before = os.path.exists(payload["lib"])
        lib = str(_build.build())
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=timedelta(minutes=10))
        mesh = parallel.create_mesh()
        out = dict(rank=rank, lib_reused=lib_before and lib == payload["lib"])
        x = torch.ones(64 << 20, dtype=torch.bfloat16, device=dev)
        rows = torch.empty(2 * x.numel(), dtype=x.dtype, device=dev)
        for name, fn in (("all_reduce", lambda: dist.all_reduce(x)),
                         ("all_gather", lambda: dist.all_gather_into_tensor(
                             rows, x))):
            fn()  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0)
        del x, rows
        args = csm_1b()
        batch = payload["batch"]
        ref, _ = par_trainer(args, dev, f"{payload['dir']}/b-ref{rank}")
        init = map_params(lambda t: t.clone(), ref.model.params)
        out["ref_losses"] = [ref.train_step(batch)
                             for _ in range(PAR_STEPS)]
        ref_params = ref.model.params
        del ref
        torch.cuda.empty_cache()
        own_row = {k: v[rank:rank + 1] for k, v in batch.items()}
        ctl, _ = par_trainer(args, dev, f"{payload['dir']}/b-ctl{rank}")
        for _ in range(PAR_STEPS):
            ctl.train_step(own_row)
        out["control"] = update_errors(ctl.model.params, ref_params, init)
        del ctl
        torch.cuda.empty_cache()
        for mode in ("replicated", "fsdp"):
            tr, held = par_trainer(
                args, dev, f"{payload['dir']}/b-{mode}{rank}", mesh, mode)
            out[mode] = par_steps(tr, held, batch)
            out[mode]["errors"] = update_errors(tr.full_params(), ref_params,
                                                init)
            del tr
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        results.put(out)
    except BaseException:  # the parent fails the phase with it
        results.put(dict(rank=rank, error=traceback.format_exc()))


def run_parallel(dev, workdir: str) -> dict:
    """The parallel fine-tuning path, CSM-1B bf16 full SFT, B=2, S=576,
    remat, at full width and depth.

    (a) One rank on NCCL in this process (`create_mesh()` over a one-rank
    group the script makes): PAR_STEPS replicated and PAR_STEPS FSDP
    steps, each from the same parameters; losses and updated parameters
    must be bit-equal to the mesh-less trainer's (every collective a
    one-rank copy). Then the paths that send point to point, which gloo
    cannot carry for CUDA tensors (`gloo_p2p_probe`, printed), on the NCCL
    rank: ring attention at (1, 32, 2048, 64) fp32 and bf16, forward and backward,
    against the plain causal attention, and the 16-layer pipeline against
    `llama_forward`.
    (b) Two ranks spawned on the one card over gloo (NCCL refuses two
    ranks on one GPU): each loads the kernels built here, runs the
    mesh-less reference, then the replicated and the FSDP steps on its
    row; losses within PAR_LOSS_RTOL and every weight matrix's update
    within PAR_UPDATE_TOL of the reference's (bf16 GEMMs of one row, the
    gradient sum in another order), while a control without the gradient
    reduce (each rank's own row) must fall outside it; and the parameter
    and AdamW bytes each rank stores."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    args = csm_1b()
    batch = train_batch(args, TRAIN_B, TRAIN_S, SEED + 91)
    info = card_info()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    mesh = parallel.create_mesh()
    ref, held = par_trainer(args, dev, f"{workdir}/a-ref")
    ref_run = par_steps(ref, held, batch)
    ref_model = ref.model
    del ref
    torch.cuda.empty_cache()
    reset_counts()
    runs = {}
    for mode in ("replicated", "fsdp"):
        tr, held = par_trainer(args, dev, f"{workdir}/a-{mode}", mesh, mode)
        runs[mode] = par_steps(tr, held, batch)
        full = tr.full_params()
        runs[mode]["bit_equal"] = (
            runs[mode]["losses"] == ref_run["losses"]
            and all(torch.equal(a, b) for a, b in zip(
                tree_to_flat(full).values(),
                tree_to_flat(ref_model.params).values())))
        del tr, full
        torch.cuda.empty_cache()
    counts = read_counts()
    launches = (counts["flash_train_fwd"], counts["flash_train_bwd"])
    for label, r in [("mesh-less", ref_run)] + list(runs.items()):
        log(f"parallel (a) one NCCL rank, {label}, CSM-1B bf16 full SFT "
            f"B={TRAIN_B} S={TRAIN_S} remat ({info}): losses "
            + ", ".join(repr(x) for x in r["losses"]) + "; ms a step "
            + ", ".join(f"{x:.1f}" for x in r["ms"]) + f"; peak "
            f"{r['peak']:.2f} GiB above what was held before; parameters + "
            f"AdamW stored "
            f"{r['stored']:.2f} GiB; kernel 6 {r['launches'][0]:.0f}, "
            f"kernel 7 {r['launches'][1]:.0f} launches a step"
            + (f"; losses and parameters bit-equal to the mesh-less "
               f"trainer {r['bit_equal']}" if "bit_equal" in r else ""))
    if not all(r["bit_equal"] for r in runs.values()):
        raise AssertionError("a one-rank mesh step is not bit-equal to the "
                             "mesh-less trainer's")
    if launches != (2 * PAR_STEPS * 2 * args.backbone_config
                    .num_hidden_layers, 2 * PAR_STEPS * args.backbone_config
                    .num_hidden_layers):
        raise AssertionError(f"kernels 6 and 7 launches {launches} in the "
                             f"mesh steps")

    p2p = gloo_p2p_probe(workdir)
    log(f"gloo point-to-point on CUDA tensors (batch_isend_irecv, two "
        f"processes on cuda:0): {'passes' if p2p['ok'] else 'fails'}, exit "
        f"codes {p2p['codes']}; gloo's error: "
        + (" | ".join(p2p["errors"]) or "none"))
    # the ring and the pipeline send point to point: one NCCL rank
    one = {f"ring {dtype}": ring_check(parallel.create_mesh({"seq": 1}),
                                       dev, dtype)
           for dtype in (torch.float32, torch.bfloat16)}
    one["pipeline"] = pipeline_check(parallel.create_mesh({"pipe": 1}), dev,
                                     ref_model)
    del ref_model
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    payload = dict(batch=batch, lib=str(_build.build()), dir=workdir,
                   device=str(dev))
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, 2, f"{workdir}/b-store", payload, results))
             for r in range(2)]
    for p in procs:
        p.start()
    ranks = {}
    deadline = time.monotonic() + PAR_TIMEOUT_S
    try:
        while len(ranks) < 2 and time.monotonic() < deadline:
            try:
                r = results.get(timeout=5)
            except __import__("queue").Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            ranks[r["rank"]] = r
            if "error" in r:
                break
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [r["error"] for r in ranks.values() if "error" in r]
    if bad or len(ranks) < 2:
        raise AssertionError("parallel (b) failed: "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(bad))
    for r in (ranks[0], ranks[1]):
        if r["ref_losses"] != ref_run["losses"]:
            raise AssertionError(f"rank {r['rank']}'s mesh-less reference "
                                 f"differs from this process's")
        whole, worst, name = r["control"]
        r["control_fails"] = whole > PAR_UPDATE_TOL and worst > PAR_UPDATE_TOL
        log(f"parallel (b) rank {r['rank']}, control: the mesh-less trainer "
            f"on its own row only (no gradient reduce), AdamW {PAR_LR:g}: "
            f"update error {whole:.3e} over every leaf, worst matrix "
            f"{worst:.3e} ({name}) of the reference update (tol "
            f"{PAR_UPDATE_TOL:g}); fails the gate {r['control_fails']}")
        for mode in ("replicated", "fsdp"):
            m = r[mode]
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(m["losses"], ref_run["losses"]))
            whole, worst, name = m["errors"]
            m["ok"] = (loss_rel <= PAR_LOSS_RTOL and whole <= PAR_UPDATE_TOL
                       and worst <= PAR_UPDATE_TOL)
            log(f"parallel (b) rank {r['rank']} of 2 on cuda:0 over gloo, "
                f"{mode} ({info}): losses "
                + ", ".join(repr(x) for x in m["losses"])
                + f" (rel err {loss_rel:.2e}, tol {PAR_LOSS_RTOL:g}); "
                f"parameters, AdamW {PAR_LR:g}: update error {whole:.3e} "
                f"over every leaf, worst matrix {worst:.3e} ({name}) of the "
                f"reference update (tol {PAR_UPDATE_TOL:g}); ms a step "
                + ", ".join(f"{x:.1f}" for x in m["ms"]) + f"; stored "
                f"parameters + AdamW {m['stored']:.2f} GiB; peak "
                f"{m['peak']:.2f} GiB above the reference it holds; kernel 6 {m['launches'][0]:.0f}, "
                f"kernel 7 {m['launches'][1]:.0f} launches a step")
        log(f"parallel (b) rank {r['rank']}: the parent's kernels reused "
            f"{r['lib_reused']}; gloo on CUDA, 128 MiB bf16: all_reduce "
            f"{r['all_reduce_ms']:.1f} ms, all_gather_into_tensor "
            f"{r['all_gather_ms']:.1f} ms")
    share = [ranks[r]["fsdp"]["stored"] / ranks[r]["replicated"]["stored"]
             for r in (0, 1)]
    log(f"parallel (b): FSDP stores {share[0]:.1%} and {share[1]:.1%} of "
        f"the replicated parameter and AdamW bytes on ranks 0 and 1")
    for label, c in one.items():
        if label.startswith("ring"):
            dtype = torch.float32 if "float32" in label else torch.bfloat16
            f_tol, g_tol = RING_TOL[dtype]
            c["ok"] = c["fwd"] <= f_tol and max(c["grads"]) <= g_tol
            log(f"{label}, (B, H, S, D) {RING_SHAPE[:3] + RING_SHAPE[4:]}, "
                f"{RING_SHAPE[3]} kv heads, on one NCCL rank: forward {c['fwd']:.2e} (tol {f_tol:g}), dq dk dv "
                + ", ".join(f"{x:.2e}" for x in c["grads"])
                + f" (tol {g_tol:g}) of the plain causal attention's "
                f"largest magnitude; forward + backward {c['ms']:.1f} ms")
        else:
            c["ok"] = c["err"] <= PIPE_TOL
            log(f"pipeline_forward, CSM-1B backbone {c['layers']} layers bf16, "
                f"{c['stages']} stage(s), {PIPE_MICRO} microbatches of "
                f"{PIPE_B // PIPE_MICRO} x {TRAIN_S - 1}, on one NCCL rank: "
                f"{c['err']:.2e} of llama_forward's largest magnitude (tol "
                f"{PIPE_TOL:g}); {c['ms']:.1f} ms")
    if not all(r["control_fails"] for r in ranks.values()):
        raise AssertionError("the update gate passes a run without the "
                             "gradient reduce: it cannot tell a wrong one")
    if not all(r[m]["ok"] for r in ranks.values()
               for m in ("replicated", "fsdp")) \
            or not all(c["ok"] for c in one.values()) \
            or not all(0.45 <= s <= 0.55 for s in share):
        raise AssertionError("parallel (b), the ring or the pipeline "
                             "disagrees, or FSDP does not halve the stored "
                             "bytes")
    return dict(launches=launches)


# --- serving: the continuous engine, the servers, HTTP, the watermark -------


def serving_engine(model: CSM, mimi, seed: int, **kw):
    """A `ContinuousEngine` at the serving defaults (64 slots, K = 8,
    prompt buckets up to 512, greedy) with its own seeded generator."""
    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    kw.setdefault("n_slots", SERVE_SLOTS)
    kw.setdefault("frames_per_step", SERVE_K)
    kw.setdefault("temperature", 0.0)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return ContinuousEngine(model, mimi=mimi, generator=gen, **kw)


def with_text_rows(model: CSM):
    """A context manager replacing the text tokenizer (absent on the card's
    machine) with `context_text_rows`."""
    import contextlib

    from csm_mlx_tpu_torch import tokenizers as port_tokenizers

    @contextlib.contextmanager
    def swap():
        saved = port_tokenizers.tokenize_text_segment
        port_tokenizers.tokenize_text_segment = \
            lambda text, *_: context_text_rows(text, model.args.n_text_vocab)
        try:
            yield
        finally:
            port_tokenizers.tokenize_text_segment = saved

    return swap()


def serving_spreads(model: CSM, prompts, frames0: np.ndarray) -> tuple:
    """The size of two noises in the logits, each (c0, decoder): the
    layout's, the std of the differences between one backbone step of each
    prompt as a solo run takes it (B = 1, its own cache of prompt bucket +
    the longest request's frames) and as the engine takes it (the prompts
    prefilled together, spliced below index 512 of a 768-slot bucket, the
    pads shifted), both from the same first frames `frames0`; and kernel
    4's, the std of the differences between the engine's step through
    kernel 4 and through the masked attention on that same cache. Logits:
    c0's and, teacher-forced on the solo run's kernel-3 tokens, the plain
    decoder's. Returns (layout, kernel 4)."""
    args, params, dev = model.args, model.params, model.device
    bcfg = args.backbone_config
    cos_b, sin_b = rope_cache_for(bcfg, bcfg.max_position_embeddings, dev)
    padded = [generation._pad_prompt(p, m) for p, m in prompts]
    tok = torch.from_numpy(np.concatenate([x[0] for x in padded])).long()
    msk = torch.from_numpy(np.concatenate([x[1] for x in padded])).long()
    pad = torch.from_numpy(np.concatenate([x[2] for x in padded])).long()
    tok, msk, pad = tok.to(dev), msk.to(dev), pad.to(dev)
    n, p = tok.shape[0], tok.shape[1]
    tk, mk = generation._frame_to_next_input(
        torch.from_numpy(frames0).long().to(dev))
    index, bucket = 512, 768

    def cache(b, cap):
        return KVCache.init(bcfg, b, cap, dtype=model.dtype, device=dev)

    with torch.no_grad():
        hs = []
        for i in range(n):
            c = cache(1, p + SERVE_FRAMES[1])
            generation._prefill(params, args, tok[i:i + 1], msk[i:i + 1],
                                pad[i:i + 1], c, cos_b, sin_b)
            hs.append(generation._backbone_step(
                params, args, tk[i:i + 1], mk[i:i + 1], pad[i:i + 1], c,
                cos_b, sin_b)[0])
        hs = torch.cat(hs)
        rows = cache(n, p)
        generation._prefill(params, args, tok, msk, pad, rows, cos_b, sin_b)
        big = cache(n, bucket)
        big.k[:, :, :, index - p:index].copy_(rows.k)
        big.v[:, :, :, index - p:index].copy_(rows.v)
        hb = []
        for flash in (None, 1):  # each step writes its own slot `index`
            big.index.fill_(index)
            big.length = index
            hb.append(generation._backbone_step(
                params, args, tk, mk, pad + index - p, big, cos_b, sin_b,
                flash)[0])
        hb, hb4 = hb
        lb = linear(params["codebook0_head"], hb).float()
        lb4 = linear(params["codebook0_head"], hb4).float()
        ls = linear(params["codebook0_head"], hs).float()
        c0 = ls.argmax(-1)

        def proj(h):
            x01 = torch.stack([h, embed_audio(params, args, 0, c0)
                               .to(h.dtype)], dim=1)
            return linear(params["projection"], x01).float().transpose(
                0, 1).contiguous()

        ps = proj(hs)
        toks = resident.resident_decode_frame(
            params["_resident"], args, ps,
            torch.zeros((), dtype=torch.int32, device=dev), 0.0)
        ds, db, db4 = (resident.resident_decode_frame_plain(
            params["_resident"], args, x, 0.0, forced=toks.long())[1]
            for x in (ps, proj(hb), proj(hb4)))
    return (((lb - ls).std().item(), (db - ds).std().item()),
            ((lb4 - lb).std().item(), (db4 - db).std().item()))


def first_pick_margins(model: CSM, prompts, gots, wants,
                       kernel4: bool = False) -> list:
    """For each request, its prompt (rows, mask), the frames `got` of the
    run under test and the reference frames `want`, which differ: the
    logits of a solo run at the first pick where they differ, teacher-forced
    on `want` before it, as (frame, codebook, kind, top logit - `got`'s
    pick's logit, one unit in the last place of the top logit in the
    logits' dtype, noise, kernel 4's pick). With `kernel4`, the requests
    also run through kernel 4 in every step, on a cache of their own, as an
    engine on kernel 4 runs them, so its rounding reaches the cached keys
    and values of every frame before the pick: `noise` is the std over the
    vocabulary of the pick's logits through kernel 4 less those through the
    masked attention, and kernel 4's pick whether the top logit through
    kernel 4 is `got`'s (both 0 and None at frame 0, the admission's; else
    0 and None). The requests are stepped together, rows of one prompt
    bucket; kernel 1 quantizes each row alone."""
    args, params, dev = model.args, model.params, model.device
    bcfg = args.backbone_config
    firsts = []
    for got, want in zip(gots, wants):
        common = min(len(got), len(want))
        diff = np.argwhere(got[:common] != want[:common])
        if not len(diff):
            raise AssertionError(f"a request of {len(got)} frames ends apart "
                                 f"from its reference of {len(want)}")
        firsts.append(tuple(int(v) for v in diff[0]))
    padded = [generation._pad_prompt(p, m) for p, m in prompts]
    if len({x[3] for x in padded}) != 1:
        raise ValueError("first_pick_margins steps prompts of one bucket")
    tokens, masks, pad = (
        torch.from_numpy(np.concatenate([x[i] for x in padded])).long().to(dev)
        for i in range(3))
    last = max(f for f, _ in firsts)
    cap = padded[0][3] + last + 1
    cos_b, sin_b = rope_cache_for(bcfg, max(cap, bcfg.max_position_embeddings),
                                  dev)
    caches = [KVCache.init(bcfg, len(prompts), cap, dtype=model.dtype,
                           device=dev) for _ in range(1 + kernel4)]
    at = [None] * len(prompts)  # each row's hidden state at its frame
    at4 = [None] * len(prompts)  # and through kernel 4
    with torch.no_grad():
        h = [generation._prefill(params, args, tokens, masks, pad, c, cos_b,
                                 sin_b)[0] for c in caches]
        h4 = h[-1]
        h = h[0]
        for i in range(last + 1):
            for r, (f, _) in enumerate(firsts):
                if f == i:
                    at[r], at4[r] = h[r], h4[r]
            if i == last:
                break
            # teacher-forced on want; a row past its frame repeats it
            frame = torch.from_numpy(np.stack(
                [w[min(i, f)] for w, (f, _) in zip(wants, firsts)])).long()
            tk, mk = generation._frame_to_next_input(frame.to(dev))
            h, _ = generation._backbone_step(params, args, tk, mk, pad,
                                             caches[0], cos_b, sin_b)
            h4 = generation._backbone_step(params, args, tk, mk, pad,
                                           caches[1], cos_b, sin_b, 1)[0] \
                if kernel4 else h
        c0 = torch.tensor([int(w[f, 0]) for w, (f, _) in zip(wants, firsts)],
                          device=dev)
        forced = torch.from_numpy(np.stack(
            [g[f] for g, (f, _) in zip(gots, firsts)]).T.copy()).long()
        logits = []
        for hid in (torch.stack(at), torch.stack(at4)):
            c0_logits = linear(params["codebook0_head"], hid)
            x01 = torch.stack([hid, embed_audio(params, args, 0, c0)
                               .to(hid.dtype)], dim=1)
            proj01 = linear(params["projection"], x01).float().transpose(
                0, 1).contiguous()
            _, dec = resident.resident_decode_frame_plain(
                params["_resident"], args, proj01, 0.0, forced=forced.to(dev))
            logits.append((c0_logits, dec))
    out = []
    for r, (f, c) in enumerate(firsts):
        pick = [c0l[r] if c == 0 else dec[c - 1, r] for c0l, dec in logits]
        top = pick[0].float().max().item()
        ulp = torch.finfo(pick[0].dtype).eps * 2.0 ** float(np.floor(
            np.log2(max(abs(top), 1e-30))))
        margin = top - pick[0][int(gots[r][f, c])].float().item()
        noise = (pick[1].float() - pick[0].float()).std().item()
        picks4 = (bool(pick[1][int(gots[r][f, c])] >= pick[1].max())
                  if kernel4 and f else None)
        out.append((f, c, "c0" if c == 0 else "decoder", margin, ulp, noise,
                    picks4))
    return out


def near_ties(model: CSM, prompts, gots, wants, spreads: tuple,
              kernel4: bool = False) -> tuple:
    """(requests whose frames equal the reference's, [(request, frame,
    codebook, margin, margin in spreads)] of the others). A first
    difference is a near tie when its margin is at most one unit in the
    last place of the top logit or under 4 spreads; the spread, the layout
    noise of `serving_spreads` (c0, decoder) for the codebook and, with
    `kernel4` (`gots` ran through kernel 4, `wants` through the masked
    attention), kernel 4's noise on that pick (`first_pick_margins`), in
    quadrature; its lines then add that noise and whether kernel 4's
    replay picks as `got` did. Returns (equal, lines, every first
    difference a near tie)."""
    apart = [i for i, (g, w) in enumerate(zip(gots, wants))
             if not np.array_equal(g, w)]
    lines, ties = [], True
    if apart:
        margins = first_pick_margins(model, [prompts[i] for i in apart],
                                     [gots[i] for i in apart],
                                     [wants[i] for i in apart], kernel4)
        for i, (f, c, kind, margin, ulp, noise, picks4) in zip(apart,
                                                              margins):
            spread = max(float(np.hypot(
                spreads[0] if kind == "c0" else spreads[1], noise)), 1e-12)
            ties &= margin <= ulp or margin < 4 * spread
            lines.append((i, f, c, f"{margin:.4g}", margin / spread)
                         + ((f"noise {noise:.4g}",
                             f"kernel 4 picks got {picks4}") if kernel4
                            else ())
                         + (("one ulp",) if margin <= ulp else ()))
    return len(gots) - len(apart), lines, ties


def run_serving(model: CSM, mimi: Mimi) -> dict:
    """The continuous engine at its defaults on full-width CSM-1B W8A8 with
    Mimi(32), greedy: the two context requests of run_context (a 512-row
    bucket: kernel 2 and kernel 1's GEMM route in their admission) and
    SERVE_REQUESTS 32-row prompts with max_frames from a seed, all
    submitted at once (64 admitted in the first drive, the rest as slots
    free), then SERVE_TAIL short ones. Gates: an admission burst of 64,
    slot reuse, a bucket grow, a rebase and a shrink with no capture of a
    bucket twice; kernels 1 (both routes), 2 and 3 launched, kernel 3
    exactly once a frame stepped and once an admission, kernel 4 once a
    layer a backbone step; a first-wave request's chunks within STREAM_TOL
    of the batch decode of its frames (a recycled row's within the JAX
    test's 2e-3); SERVE_SOLO requests against their solo `generate_tokens`
    runs (the masked attention), each first difference a near tie by
    `near_ties`: a margin under 4 spreads of the layout noise and kernel
    4's noise on that pick, in quadrature; kernel 4 on the engine's cache
    view as `kernel4_on_engine_view` checks it."""
    args, dev, card = model.args, model.device, card_info()
    rng = np.random.RandomState(SEED + 400)
    reqs = [(*synthetic_prompt(32, args.n_text_vocab, SEED + 500 + i),
             int(rng.randint(SERVE_FRAMES[0], SERVE_FRAMES[1] + 1)))
            for i in range(SERVE_REQUESTS)]
    ctx = context_segments()
    with with_text_rows(model):
        ctx_prompts = [generation._assemble_prompt(model, t, i, ctx, mimi)
                       for i, t in enumerate((
                           "And the water was higher than I have ever seen.",
                           "Then it started to rain again."))]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    eng = serving_engine(model, mimi, SEED + 401)
    torch.cuda.synchronize()
    mem_static = torch.cuda.memory_allocated() - mem0
    cache_gib = 2 * eng._cache.k.numel() * eng._cache.k.element_size() / 2**30
    reset_counts()
    t0 = time.perf_counter()
    ctx_res = [eng.submit_prompt(p, m, max_frames=SERVE_CONTEXT_FRAMES)
               for p, m in ctx_prompts]
    results = [eng.submit_prompt(p, m, max_frames=mf) for p, m, mf in reqs]
    eng._drive_once()
    burst = eng.stats.admissions
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main = dataclass_replace(eng.stats)
    tail = [eng.submit_prompt(*synthetic_prompt(32, args.n_text_vocab,
                                                SEED + 700 + i), max_frames=16)
            for i in range(SERVE_TAIL)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    counts = read_counts()
    st = eng.stats
    reserved = torch.cuda.memory_reserved() - res0
    graphs = sorted(b for b, g in eng._graphs.items() if g != "warm")
    lat = st.first_chunk_latency_ms()
    fps = main.frames_emitted / wall
    log(f"continuous engine, CSM-1B W8A8 + Mimi(32), {SERVE_SLOTS} slots, "
        f"K={SERVE_K}, capacity {eng.capacity}, KV buckets {eng._kv_buckets} "
        f"({card}): {len(ctx_res)} context requests of "
        f"{[len(p) for p, _ in ctx_prompts]} rows for "
        f"{SERVE_CONTEXT_FRAMES} frames and {SERVE_REQUESTS} 32-row requests "
        f"of {SERVE_FRAMES[0]}-{SERVE_FRAMES[1]} frames: {wall:.2f} s, "
        f"{main.steps} blocks ({1e3 * wall / main.steps:.2f} ms a block in "
        f"all, admissions and fetches included), {main.frames_emitted} "
        f"frames emitted = {fps:.1f} frames/s, aggregate RTF {fps * 0.08:.2f}; "
        f"{main.frames_wasted} slot-frames wasted; first chunk after "
        f"admission p50 {lat['admit_p50_ms']} ms p90 {lat['admit_p90_ms']} "
        f"ms, after submission p50 {lat['submit_p50_ms']} ms p90 "
        f"{lat['submit_p90_ms']} ms")
    log(f"continuous engine counters (then {SERVE_TAIL} short requests): "
        f"admissions {st.admissions} in {st.admit_batches} prefills (first "
        f"drive {burst}), completed {st.completed}, blocks {st.steps}, "
        f"bucket grows {st.cache_grows}, shrinks "
        f"{st.cache_resizes - st.cache_grows}, rebases {st.rebases}, graphs "
        f"captured {st.graph_captures} for buckets {graphs}; KV cache "
        f"{cache_gib:.2f} GiB ({mem_static / 2**30:.2f} GiB of static "
        f"buffers in all), reserved after the run +{reserved / 2**30:.2f} "
        f"GiB (graph pool, admission temporaries); launches {counts}")
    k3_want = SERVE_K * st.steps + st.admit_batches
    k4_want = args.backbone_config.num_hidden_layers * SERVE_K * st.steps
    if burst != SERVE_SLOTS or st.admissions <= SERVE_SLOTS \
            or st.completed != len(reqs) + len(ctx_res) + len(tail) \
            or st.cache_grows < 1 or st.rebases < 1 \
            or st.cache_resizes - st.cache_grows < 1 \
            or st.graph_captures != len(graphs):
        raise AssertionError("the engine's counters miss a burst, slot "
                             "reuse, a grow, a rebase or a shrink, or a "
                             "bucket was captured twice")
    if counts["resident_decode_frame"] != k3_want \
            or counts["flash_decode_sdpa"] != k4_want \
            or counts["flash_prefill_sdpa"] < 1 \
            or counts["w8a8_matvec.gemm"] < 1 \
            or counts["w8a8_matvec"] <= counts["w8a8_matvec.gemm"]:
        raise AssertionError(f"serving launches {counts}: want kernel 3 "
                             f"{k3_want} times, kernel 4 {k4_want} times, "
                             f"kernel 2 and both routes of kernel 1")

    # chunks: a first-wave request (a fresh row) and a recycled one
    for label, res, tol_rel in (("first-wave", results[0], STREAM_TOL),
                                ("recycled-row", results[-1], 2e-3)):
        frames = res.wait(0)
        audio = res.audio()
        want = mimi.decode(torch.from_numpy(frames.T[None].copy()).to(dev))
        want = want[0, 0].cpu().numpy()
        err = float(np.abs(audio - want).max())
        tol = tol_rel * float(np.abs(want).max())
        log(f"engine chunks of a {label} request ({len(frames)} frames) vs "
            f"mimi.decode of its frames: max_abs_err {err:.3e} (tol {tol:.3e})")
        if audio.shape != want.shape or not err <= tol:
            raise AssertionError(f"the engine's chunks of a {label} request "
                                 f"do not match the batch decode")

    # against solo runs
    (spread_c0, spread_dec), spreads_k4 = serving_spreads(
        model, [(p, m) for p, m, _ in reqs[:16]],
        np.stack([r.wait(0)[0] for r in results[:16]]))
    picks = [0, 1, 2, 3] + list(range(SERVE_REQUESTS - SERVE_SOLO + 4,
                                      SERVE_REQUESTS))
    solo = [generate_tokens(model, *reqs[i], temperature=0.0) for i in picks]
    equal, lines, ties = near_ties(model, [reqs[i][:2] for i in picks],
                                   [results[i].wait(0) for i in picks],
                                   [want[:n] for want, n in solo],
                                   (spread_c0, spread_dec), kernel4=True)
    lines = [(picks[j], *rest) for j, *rest in lines]
    log(f"engine vs solo generate_tokens ({card}): {equal} of {len(picks)} "
        f"requests equal frame for frame; first differences (request, "
        f"frame, codebook, margin, margin in spreads, kernel 4's noise on "
        f"the pick, its replay's pick): {lines}; spreads (std of "
        f"the logits of a step as solo runs and as the engine take it) c0 "
        f"{spread_c0:.4f}, decoder {spread_dec:.4f}; kernel 4's (a step of "
        f"the engine through it and through the masked attention) c0 "
        f"{spreads_k4[0]:.4f}, decoder {spreads_k4[1]:.4f}")
    if not ties:
        raise AssertionError("an engine request's first difference from its "
                             "solo run is not a near tie")
    k4 = kernel4_on_engine_view(eng)
    del eng
    torch.cuda.empty_cache()
    return dict(counts=counts, ms_block_all=1e3 * wall / main.steps,
                fps=fps, first_chunk=lat, solo_equal=(equal, len(picks)),
                spreads=(spread_c0, spread_dec),
                k4_view_err=k4)


def kernel4_on_engine_view(eng) -> float:
    """Kernel 4 against `flash_decode_plain` on every layer of the engine's
    cache as a bucket's graph reads it: the prefix view of the
    full-capacity buffer (not contiguous), the engine's spliced pads and
    clamped dead rows, at its index (below the bucket's end), a random
    bf16 query of the backbone's heads; tolerance FLASH_DECODE_TOL times
    max |plain| where that is below 1. Then every key and value of a row
    outside its valid range (pad <= j <= index: a recycled row's earlier
    request, the slots past the index) is overwritten with KV_POISON in
    place, and kernel 4's output must not move by a bit. The largest
    error."""
    bcfg, dev = eng.args.backbone_config, eng.device
    view = eng._view(eng._cap)
    if view.k[0].is_contiguous():
        raise AssertionError(f"the engine's bucket {eng._cap} is its whole "
                             f"cache of {eng.capacity}: no prefix view")
    index = torch.full((), min(eng._idx, eng._cap - 1), dtype=torch.int32,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 405)
    heads, d = bcfg.num_attention_heads, bcfg.head_dim
    q = torch.randn((eng.n_slots, heads, 1, d), generator=gen,
                    device=dev).to(view.k.dtype)
    pos = torch.arange(eng._cap, device=dev)[None, :]
    live = eng._pad <= index  # the rows with a valid key
    outside = ((pos < eng._pad[:, None]) | (pos > index)) & live[:, None]
    worst, worst_tol = 0.0, 0.0
    for layer in range(bcfg.num_hidden_layers):
        k, v = view.k[layer], view.v[layer]
        got = attention.flash_decode_sdpa(q, k, v, d ** -0.5, eng._pad, index)
        want = attention.flash_decode_plain(q, k, v, d ** -0.5, eng._pad,
                                            index)
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_DECODE_TOL[q.dtype] * (
            min(1.0, want.float().abs().max().item())
            if q.dtype == torch.bfloat16 else 1.0)
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"kernel 4 on the engine's cache view, layer "
                                 f"{layer}: max_abs_err {err:.3e} (tol "
                                 f"{tol:.3e})")
        if err >= worst:
            worst, worst_tol = err, tol
        k.masked_fill_(outside[:, None, :, None], KV_POISON)
        v.masked_fill_(outside[:, None, :, None], KV_POISON)
        poisoned = attention.flash_decode_sdpa(q, k, v, d ** -0.5, eng._pad,
                                               index)
        if not torch.equal(poisoned[live], got[live]):
            raise AssertionError(f"kernel 4 on the engine's cache view, layer "
                                 f"{layer}, reads a key or value outside a "
                                 f"row's valid range")
    log(f"kernel 4 vs flash_decode_plain on the engine's cache view "
        f"({eng.n_slots} rows, bucket {eng._cap} of {eng.capacity} slots, "
        f"strides {tuple(view.k[0].stride())}, index {int(index)}, pads "
        f"{int(eng._pad.min())}-{int(eng._pad.max())}, {q.dtype}), "
        f"{bcfg.num_hidden_layers} layers: max_abs_err {worst:.3e} (tol "
        f"{worst_tol:.3e}); bit-equal with the keys and values of the "
        f"{int(outside.sum())} slots outside the {int(live.sum())} live "
        f"rows' valid ranges set to {KV_POISON:g}")
    return worst


def engine_ab_run(eng, prompts, frames: int) -> tuple:
    """The prompts through `eng` for `frames` frames each: (the requests'
    frames, ms a block in steady state: from its third block to the end,
    fetches included)."""
    res = [eng.submit_prompt(p, m, max_frames=frames) for p, m in prompts]
    eng._drive_once()  # the admissions and a block
    eng._drive_once()
    torch.cuda.synchronize()
    n0, t0 = eng.stats.steps, time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (eng.stats.steps - n0)
    return [r.wait(0) for r in res], [r.audio() for r in res], ms


def block_split(eng, prompts) -> dict:
    """Device ms of one step block's parts on an engine built with
    `eager=True`, every slot busy with `prompts`: the engine's own eager
    block with its timing marks (`ContinuousEngine.block_marks`), split
    into the K backbone steps, the K frames' decode (c0, kernel 3, the
    seeds and copies) and the Mimi step of the K frames owed with its
    chunks. The block after the admissions' is timed; the requests then
    run out."""
    k = eng.frames_per_step
    for p, m in prompts:
        eng.submit_prompt(p, m, max_frames=3 * k)
    eng._drive_once()  # the admissions and a block
    eng.block_marks = marks = []
    eng._drive_once()
    torch.cuda.synchronize()
    eng.block_marks = None
    eng.run_until_idle()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return dict(backbone=sum(ms[0:2 * k:2]), decoder=sum(ms[1:2 * k:2]),
                mimi=ms[-1], block=sum(ms))


def run_serving_ab(model: CSM, mimi: Mimi, spreads: tuple) -> dict:
    """64 32-row requests of SERVE_AB_FRAMES frames through two fresh
    engines, captured blocks and eager ones, alternated (captured, eager,
    eager, captured; the two engines stay in the same state, so their
    layouts match): gate, equal frames and chunks. Then the same through a
    fresh engine with `transfer="int16"` (gate: equal frames, chunks within
    one step of the 16-bit grid), T = 0.8 (gate: each block's kernel-3
    seed new, rows of one prompt apart, codes in the vocabulary), and with
    `flash_decode_min_b=8` against the captured engine, alternated (gates:
    16 kernel-4 launches a backbone step; each of its runs' requests equal
    to the captured engine's run of the same order, or its first
    difference a near tie by `near_ties`: a margin, in a solo run's
    logits, of one unit in the last place or under 4 spreads, the layout
    noise `spreads` of run_serving and kernel 4's noise on that pick in
    quadrature)."""
    args, card = model.args, card_info()
    prompts = [synthetic_prompt(32, args.n_text_vocab, SEED + 800 + i)
               for i in range(SERVE_SLOTS)]
    engines = {e: serving_engine(model, mimi, SEED + 402,
                                 max_frames=SERVE_AB_CAP, eager=e,
                                 flash_decode_min_b=None)
               for e in (False, True)}
    runs: dict = {False: [], True: []}
    for eager in (False, True, True, False):
        runs[eager].append(engine_ab_run(engines[eager], prompts,
                                         SERVE_AB_FRAMES))
    for (cf, ca, _), (ef, ea, _) in zip(runs[False], runs[True]):
        if not (all(np.array_equal(a, b) for a, b in zip(cf, ef))
                and all(np.array_equal(a, b) for a, b in zip(ca, ea))):
            raise AssertionError("the engine's captured blocks differ from "
                                 "its eager blocks")
    ms = {e: [r[2] for r in runs[e]] for e in runs}
    log(f"engine block (K={SERVE_K}, {SERVE_SLOTS} slots busy) captured vs "
        f"eager, alternated captured/eager/eager/captured ({card}): frames "
        f"and chunks equal; ms a block captured "
        f"{', '.join(f'{t:.2f}' for t in ms[False])}, eager "
        f"{', '.join(f'{t:.2f}' for t in ms[True])}; graphs captured "
        f"{engines[False].stats.graph_captures}")
    want_frames, want_audio = runs[False][0][0], runs[False][0][1]
    del engines[True]
    torch.cuda.empty_cache()
    splits = {}
    for label, kw in (("masked attention", dict(flash_decode_min_b=None)),
                      ("kernel 4", dict(flash_decode_min_b=8))):
        eng = serving_engine(model, mimi, SEED + 404, max_frames=SERVE_AB_CAP,
                             eager=True, **kw)
        splits[label] = block_split(eng, prompts)
        cap = eng.capacity
        del eng
    log(f"one block's device ms by part (eager, CUDA events, {SERVE_SLOTS} "
        f"slots, a {cap}-slot cache; {card}): " + "; ".join(
            f"{label}: " + ", ".join(f"{k} {v:.2f}" for k, v in sp.items())
            for label, sp in splits.items()))

    i16 = serving_engine(model, mimi, SEED + 402, max_frames=SERVE_AB_CAP,
                         transfer="int16", flash_decode_min_b=None)
    frames16, audio16, _ = engine_ab_run(i16, prompts, SERVE_AB_FRAMES)
    del i16
    grid = max(float(np.abs(np.clip(a, -1, 1) - b).max())
               for a, b in zip(want_audio, audio16))
    log(f"engine transfer=int16: frames equal "
        f"{all(np.array_equal(a, b) for a, b in zip(want_frames, frames16))}"
        f", chunks within {grid * 32767:.3f} steps of the 16-bit grid")
    if not all(np.array_equal(a, b) for a, b in zip(want_frames, frames16)) \
            or grid > 1.0 / 32767 + 1e-7:
        raise AssertionError("the int16 chunks leave the 16-bit grid")

    sampled = serving_engine(model, None, SEED + 403, codec=False,
                             max_frames=SERVE_AB_CAP, temperature=0.8)
    p, m = prompts[0]
    res = [sampled.submit_prompt(p, m, max_frames=SERVE_SAMPLED_FRAMES)
           for _ in range(SERVE_SLOTS)]
    seeds = []
    while sampled._drive_once():
        seeds.append(int(sampled._seeds[0]))
    toks = [r.wait(0) for r in res]
    all_toks = np.concatenate(toks)
    distinct_rows = len({t.tobytes() for t in toks})
    log(f"engine T=0.8: {sampled.stats.steps} blocks "
        f"({sampled.stats.graph_captures} graph, replays after the first), "
        f"the last frame's "
        f"kernel-3 seed of each block {len(set(seeds))} distinct of "
        f"{len(seeds)}; {distinct_rows} distinct streams of {SERVE_SLOTS} "
        f"rows of one prompt; {len(set(all_toks[:, 0].tolist()))} distinct "
        f"c0")
    if len(set(seeds)) != len(seeds) or distinct_rows < SERVE_SLOTS // 2 \
            or len(set(all_toks[:, 0].tolist())) < 5 \
            or int(all_toks.min()) < 0 \
            or int(all_toks.max()) >= args.n_audio_vocab:
        raise AssertionError("the engine's replays repeat their draws")
    del sampled

    fd = serving_engine(model, mimi, SEED + 402, max_frames=SERVE_AB_CAP,
                        flash_decode_min_b=8)
    fd_ms: dict = {False: [], True: []}
    k4 = []  # (kernel-4 launches, 16 a backbone step) of the runs with it
    fd_frames = []
    layers = args.backbone_config.num_hidden_layers
    for flash in (False, True, True, False):
        eng = fd if flash else engines[False]
        reset_counts()
        steps0 = eng.stats.steps
        frames, _, t = engine_ab_run(eng, prompts, SERVE_AB_FRAMES)
        counts = read_counts()
        fd_ms[flash].append(t)
        if flash:
            k4.append((counts["flash_decode_sdpa"],
                       layers * SERVE_K * (eng.stats.steps - steps0)))
            fd_counts = counts
            fd_frames.append(frames)
    # the kernel-4 engine's runs against the captured engine's first two,
    # the same submissions from the same engine state
    ties = [near_ties(model, prompts, got, want, spreads, kernel4=True)
            for got, (want, _, _) in zip(fd_frames, runs[False])]
    log(f"engine block with flash_decode_min_b=8 (kernel 4) vs without, "
        f"alternated off/on/on/off ({card}): ms a block with "
        f"{', '.join(f'{t:.2f}' for t in fd_ms[True])}, without "
        f"{', '.join(f'{t:.2f}' for t in fd_ms[False])}; kernel-4 launches "
        f"(want) {k4}; launches of the last run with it {fd_counts}; "
        f"requests equal to the engine's without kernel 4 frame for frame "
        f"{[eq for eq, _, _ in ties]} of {len(prompts)} a run; first "
        f"differences (request, frame, codebook, margin, margin in "
        f"spreads, kernel 4's noise on the pick, its replay's pick) "
        f"{[lines for _, lines, _ in ties]}")
    if any(got != want for got, want in k4):
        raise AssertionError("kernel 4 did not run once a layer a backbone "
                             "step")
    if not all(ok for _, _, ok in ties):
        raise AssertionError("a first difference of the kernel-4 engine from "
                             "the engine without it is not a near tie")
    del fd, engines
    torch.cuda.empty_cache()
    return dict(ms_captured=float(np.mean(ms[False])),
                ms_eager=float(np.mean(ms[True])), splits=splits,
                ms_flash=float(np.mean(fd_ms[True])),
                ms_no_flash=float(np.mean(fd_ms[False])),
                flash_counts=fd_counts,
                flash_equal=[eq for eq, _, _ in ties])


def wav_samples(body: bytes) -> np.ndarray:
    """The 16-bit samples of `serve.wav_bytes`'s RIFF layout, its header
    checked."""
    import struct

    if body[:4] != b"RIFF" or body[8:12] != b"WAVE" \
            or struct.unpack("<I", body[24:28])[0] != 24000 \
            or struct.unpack("<I", body[40:44])[0] != len(body) - 44:
        raise AssertionError("a malformed WAV body")
    return np.frombuffer(body[44:], "<i2")


async def http_session(server, text: str, joint: bool = False) -> dict:
    """`serve_http` over `server` on 127.0.0.1:0: /healthz, /tts and
    /tts-stream of `text` (sent together with `joint`, so that a continuous
    server admits both in one prefill), /stats; the raw responses."""
    import asyncio

    from csm_mlx_tpu_torch.serve import serve_http

    http = await serve_http(server, host="127.0.0.1", port=0)
    port = http.sockets[0].getsockname()[1]

    async def request(raw: bytes) -> bytes:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(raw)
        await writer.drain()
        data = await reader.read()
        writer.close()
        return data

    def post(path):
        body = json.dumps({"text": text, "speaker": 0}).encode()
        return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
                f"{len(body)}\r\n\r\n".encode() + body)

    out = {"healthz": await request(b"GET /healthz HTTP/1.1\r\n\r\n")}
    if joint:
        server.engine.stop()  # submit both before the engine drives again
        tts = asyncio.ensure_future(request(post("/tts")))
        stream = asyncio.ensure_future(request(post("/tts-stream")))
        while server.engine.pending() < 2:
            await asyncio.sleep(0.005)
        server.engine.start()
        out["tts"], out["stream"] = await tts, await stream
    else:
        out["tts"] = await request(post("/tts"))
        out["stream"] = await request(post("/tts-stream"))
    out["stats"] = await request(b"GET /stats HTTP/1.1\r\n\r\n")
    http.close()
    await http.wait_closed()
    await server.stop()
    return out


def dechunk(payload: bytes) -> bytes:
    out = []
    while payload:
        size_hex, _, payload = payload.partition(b"\r\n")
        size = int(size_hex, 16)
        if size == 0:
            break
        out.append(payload[:size])
        payload = payload[size + 2:]
    return b"".join(out)


def run_http(model: CSM, mimi: Mimi) -> dict:
    """Both servers as the `serve` CLI makes them (`cli.serve.make_server`
    from its flags; the random CSM-1B in place of loaded weights, `mimi`
    installed as the codec singleton, the text tokenizer replaced), greedy,
    SERVE_HTTP_MS of audio a request, through `serve_http`: /healthz,
    POST /tts (gate: a WAV of 1,920 samples a frame), POST /tts-stream
    (gate: chunked audio/L16 whose samples are the /tts body's within
    STREAM_TOL of its peak plus one step), GET /stats; a 503 past
    --max-pending 0 on /tts and /tts-stream; then `--watermark-key` on one
    request of WATERMARK_MS through each server (the continuous one with one
    slot; gate: the mark detected with its payload in the samples on the
    card and on the CPU)."""
    import asyncio

    from csm_mlx_tpu_torch import tokenizers as port_tokenizers
    from csm_mlx_tpu_torch import watermark
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.serve import make_server

    card = card_info()
    key = (model.n_audio_codebooks,
           str(port_tokenizers._codec_device(model.device)))
    saved = port_tokenizers._MIMI_CACHE.get(key)
    port_tokenizers._MIMI_CACHE[key] = (None, mimi)

    def server(*flags):
        args = build_parser().parse_args(
            ["serve", "--temperature", "0", "--max-audio-length",
             str(SERVE_HTTP_MS), *flags])
        return make_server(args, model)

    out: dict = {}
    try:
        with with_text_rows(model):
            for label, flags in (("lockstep", ()),
                                 ("continuous", ("--continuous",))):
                t0 = time.perf_counter()
                r = asyncio.run(http_session(
                    server(*flags), "Meet me at the station at noon.",
                    joint=bool(flags)))
                wall = time.perf_counter() - t0
                head, _, body = r["tts"].partition(b"\r\n\r\n")
                shead, _, spay = r["stream"].partition(b"\r\n\r\n")
                whole = wav_samples(body).astype(np.int32)
                streamed = np.frombuffer(dechunk(spay), "<i2").astype(
                    np.int32)
                diff = int(np.abs(streamed - whole).max()) \
                    if streamed.shape == whole.shape else None
                tol = STREAM_TOL * int(np.abs(whole).max()) + 1
                stats = json.loads(r["stats"].split(b"\r\n\r\n", 1)[1])
                log(f"HTTP, {label} server ({card}): /healthz "
                    f"{r['healthz'][:15]!r}; /tts {head.split(b' ')[1]} "
                    f"{len(whole)} samples ({len(whole) // 1920} frames); "
                    f"/tts-stream {shead.split(b' ')[1]} {len(streamed)} "
                    f"samples, max |stream - /tts| {diff} steps (tol "
                    f"{tol:.1f}); /stats {stats}; {wall:.2f} s")
                if not (r["healthz"].endswith(b"ok")
                        and head.startswith(b"HTTP/1.1 200")
                        and b"audio/wav" in head
                        and shead.startswith(b"HTTP/1.1 200")
                        and b"Transfer-Encoding: chunked" in shead
                        and b"audio/L16" in shead
                        and len(whole) and len(whole) % 1920 == 0
                        and len(whole) <= SERVE_HTTP_MS // 80 * 1920
                        and diff is not None and diff <= tol
                        and stats["requests"] == 2
                        and (label == "lockstep"
                             or stats["engine"]["admissions"] == 2)):
                    raise AssertionError(f"the {label} server's HTTP answers "
                                         f"fail their checks")
                out[label] = wall
                busy = server(*flags, "--max-pending", "0", "--slots", "1")
                r = asyncio.run(http_session(busy, "Too many."))
                codes = (r["tts"][:12], r["stream"][:12])
                log(f"HTTP, {label} server with --max-pending 0: /tts "
                    f"{codes[0]!r}, /tts-stream {codes[1]!r}")
                if codes != (b"HTTP/1.1 503",) * 2:
                    raise AssertionError("no 503 past max_pending")

            async def marked(srv):
                try:
                    return await srv.synthesize("The river was high.")
                finally:
                    await srv.stop()

            marks = {label: asyncio.run(marked(server(
                *flags, "--watermark-key", str(WATERMARK_KEY),
                "--max-audio-length", str(WATERMARK_MS))))
                for label, flags in (("lockstep", ()),
                                     ("continuous", ("--continuous",
                                                     "--slots", "1")))}
        for label, audio in marks.items():
            samples = audio.astype(np.float32)
            found = {}
            for where in ("cuda", "cpu"):
                res = watermark.detect_watermark(samples, WATERMARK_KEY,
                                                 device=where)
                wrong = watermark.detect_watermark(samples, WATERMARK_KEY + 1,
                                                   device=where)
                found[where] = (bool(res.present),
                                bool(watermark.check_payload(
                                    res, WATERMARK_KEY)),
                                float(res.score), float(wrong.score))
            log(f"--watermark-key {WATERMARK_KEY}, one request of "
                f"{len(samples)} samples through the {label} server "
                f"({card}): (present, payload, score, wrong key's score) "
                f"{found}")
            if not all(p and ok for p, ok, *_ in found.values()):
                raise AssertionError(f"the {label} server's watermark is not "
                                     f"detected")
    finally:
        if saved is None:
            port_tokenizers._MIMI_CACHE.pop(key, None)
        else:
            port_tokenizers._MIMI_CACHE[key] = saved
    return out


def kernel1_case(label: str, q: dict, rows: int, gen, dtype=torch.bfloat16
                 ) -> float:
    """Kernel 1 against its plain version on the codes of `q` at `rows`
    random rows (`kernel1_vs_plain`, `check_w8a8`'s tolerance). Returns
    the largest error."""
    out_dim, in_dim = q["weight_q"].shape
    x = torch.randn((rows, in_dim), generator=gen,
                    device=q["weight_q"].device).to(dtype)
    err, scale, routed, ok = kernel1_vs_plain(x, q)
    log(f"{label} B={rows:4d} {str(dtype)[6:]:8s} IN={in_dim:5d} "
        f"OUT={out_dim:5d} [{'tensor cores' if routed else 'matvec'}]  "
        f"max_abs_err={err:.3e} (tol 2^-7*|y| + {1e-3 * scale:.2e})  "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"kernel 1 disagrees on {label} at B={rows}")
    return err


def kernel1_timing(label: str, qs: list, rows: int, gen,
                   code_bits: int = 8) -> dict:
    """Device ms of kernel 1 and of its plain version at `rows` bf16 rows,
    cycling over the code tables `qs` (as a frame reads them: cold in L2),
    with the bound of one call and, above 16 rows, `torch._int_mm` on the
    same codes, cycled the same way. `code_bits=4` adds the bound of the
    same call with packed 4-bit codes, half a byte each."""
    out_dim, in_dim = qs[0]["weight_q"].shape
    x = torch.randn((rows, in_dim), generator=gen,
                    device=qs[0]["weight_q"].device).to(torch.bfloat16)
    it = iter(range(1 << 30))

    def run(fn):
        q = qs[next(it) % len(qs)]
        fn(x, q["weight_q"], q["scales"], q["biases"])

    ms_k = time_ms(lambda: run(quant.w8a8_matvec))[0]
    ms_p = time_ms(lambda: run(quant.w8a8_matvec_plain))[0]
    rest = 8 * out_dim + rows * (in_dim + out_dim) * 2
    b_ms, b_by = bound_ms(in_dim * out_dim + rest,
                          2 * rows * in_dim * out_dim, "int8")
    lib = int_mm_ms(x, [q["weight_q"] for q in qs]) if rows > 16 else None
    out = dict(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib)
    packed = ""
    if code_bits != 8:
        p_ms, p_by = bound_ms(in_dim * out_dim * code_bits / 8 + rest,
                              2 * rows * in_dim * out_dim, "int8")
        out.update(bound_packed_ms=p_ms, bound_packed_by=p_by)
        packed = (f"; with packed {code_bits}-bit codes {1e3 * p_ms:.2f} us "
                  f"({p_by}) = {p_ms / ms_k:.1%}")
    log(f"{label} B={rows} ({card_info()}): kernel {1e3 * ms_k:.2f} us "
        f"device over {len(qs)} tables, plain {1e3 * ms_p:.2f} us; bound "
        f"{1e3 * b_ms:.2f} us ({b_by}) = {b_ms / ms_k:.1%} of the kernel"
        + packed
        + (f"; torch._int_mm on the same codes over the same tables "
           f"{1e3 * lib:.2f} us" if lib is not None else ""))
    return out


def run_w4a8(dev, w8a8: dict, frame: dict, main_path: dict) -> dict:
    """CSM-1B W4A8 (`quantize_model(mode="w4a8")`, fused, random weights
    from SEED as the W8A8 model's): codes in [-7, 7] in int8 carriers and
    kernel 3's tables. Kernel 3 on the W4A8 tables against its plain
    version at B = 1 and 64 (`resident_case`: bit-equal logits); kernel 1
    on the 4-bit codes at 1, 64 and 300 rows against its plain version;
    the main path, 125 greedy frames from the 32-row prompt, captured
    against eager (equal frames; kernels 1 and 3 counted, kernel 3 once a
    frame); ms a frame, and kernel 1's and kernel 3's times beside
    W8A8's, with their bounds as the int8 carriers read and as packed
    4-bit codes would."""
    args = csm_1b()
    t0 = time.perf_counter()
    model = random_csm(args, torch.bfloat16, dev, SEED)
    quant.quantize_model(model, mode="w4a8", fuse=True)
    torch.cuda.synchronize()
    if "_resident" not in model.params:
        raise AssertionError("W4A8 quantize_model prepared no kernel-3 tables")
    layers = model.params["backbone"]["layers"]
    codes = [lp["mlp"]["gateup_proj"] for lp in layers]
    widest = max(int(c["weight_q"].abs().max()) for c in codes)
    if widest != 7 or any(c["weight_q"].dtype != torch.int8 for c in codes):
        raise AssertionError(f"W4A8 codes are not 4-bit in int8 ({widest})")
    log(f"CSM-1B random init (seed {SEED}) + W4A8 + kernel-3 tables: "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 120)
    err = 0.0
    for name, q in (("backbone gate-up", codes[0]),
                    ("backbone down", layers[0]["mlp"]["down_proj"]),
                    ("decoder qkv", model.params["decoder"]["layers"][0]
                     ["self_attn"]["qkv_proj"])):
        for rows in (1, 64, 300):
            err = max(err, kernel1_case(f"w4a8 {name:16s}", q, rows, gen))
    timing = {rows: kernel1_timing("w4a8 backbone gate-up", codes, rows, gen,
                                   code_bits=4)
              for rows in (1, 64)}
    log(f"w4a8 backbone gate-up B=1: kernel {1e3 * timing[1]['ms']:.2f} us "
        f"against W8A8's {1e3 * w8a8['ms']:.2f} us in this run (the same "
        f"int8 bytes)")
    k3 = {}
    for rows in (1, 64):
        k3[rows], _, _ = resident_case(model, rows, gen, label="w4a8 resident")
        p_ms, p_by = resident_bound(model.params["_resident"], args, rows,
                                    code_bits=4)
        k3[rows].update(bound_packed_ms=p_ms, bound_packed_by=p_by)
        log(f"w4a8 resident B={rows}: kernel 3 {k3[rows]['ms']:.4f} ms against"
            f" W8A8's {frame[rows]['ms']:.4f} ms in this run; bound with "
            f"packed 4-bit codes {p_ms:.4f} ms ({p_by}) = "
            f"{p_ms / k3[rows]['ms']:.1%} of the kernel")
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    ab = captured_vs_eager(
        lambda eager, n: generate_tokens(model, prompt, mask, n,
                                         temperature=0.0, _eager_step=eager),
        "main path W4A8", 125)
    n = int(ab["n"])
    counts = ab["counts"]
    if counts["resident_decode_frame"] != n or counts["w8a8_matvec"] < 1:
        raise AssertionError(f"W4A8 frames did not run kernels 1 and 3 "
                             f"({counts})")
    log(f"main path W4A8 ({card_info()}): {ab['ms_captured']:.2f} ms a frame "
        f"captured, {ab['ms_eager']:.2f} eager, against W8A8's "
        f"{main_path['ms_per_frame']:.2f} / {main_path['ms_eager']:.2f} in "
        f"this run; launches {counts}")
    del model
    torch.cuda.empty_cache()
    return dict(kernel1=dict(max_abs_err=err, **timing[1]),
                kernel1_64=timing[64], kernel3=k3, counts=counts,
                ms_per_frame=ab["ms_captured"], ms_eager=ab["ms_eager"])


def replay_step(model: CSM, frames: int) -> "generation.FrameStep":
    """The captured frame step at B = 1 from the 32-row prompt, greedy,
    past its prefill, first frame, warm-up frame and capture, with room
    for `frames` more."""
    prompt, mask = synthetic_prompt(32, model.args.n_text_vocab, SEED)
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    step = generation.FrameStep(model, 1, bucket + frames + 3,
                                SamplerConfig(temperature=0.0), (), None)
    step.first(step.prefill(tokens, masks, pad))
    step()
    step()
    return step


def time_replays(step, frames: int) -> dict:
    """Device ms and launch counts a frame of `frames` replays of `step`,
    the counts set to 0 just before: CUDA events around the replays, which
    queue with no host read between them (the frame loop's EOS read left
    out), so the events time the frames' own work: no prefill, no eager
    first frame."""
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        step()
    end.record()
    torch.cuda.synchronize()
    return dict(ms=start.elapsed_time(end) / frames,
                counts={k: v / frames for k, v in read_counts().items()})


def run_int8_head(model: CSM, disp: dict) -> dict:
    """The W8A8 CSM-1B with "audio_head" among `quantize_model`'s targets
    (`quantize_audio_head`: 31 heads of 1024 -> 2051, padded to 2176 rows,
    8-bit per row), which runs the dispatched decoder: kernel 1 on a head
    at 1 and 64 rows against its plain version; 20 greedy frames captured
    against eager (equal frames); then the raw head's dispatched decoder
    and the int8 head's, each a captured frame step, 10 replayed frames
    at a time, alternated raw, int8, int8, raw: device ms a frame and
    kernel-1 launches a frame (the int8 head's 31 more: one a codebook);
    their profiled frames (`profile_frames`); kernel 1's time at the
    head's shape with its bound and, at 64 rows, `torch._int_mm`'s."""
    args = model.args
    raw = {k: v for k, v in model.params.items() if k != "_resident"}
    dispatched = CSM(args, params=raw, dtype=model.dtype)
    head_model = CSM(args, params=dict(raw), dtype=model.dtype)
    quant.quantize_model(head_model, mode="w8a8", targets=("audio_head",),
                         fuse=False)
    head = head_model.params["audio_head"]
    n_heads = args.n_audio_codebooks - 1
    shape = (n_heads, -(-args.n_audio_vocab // 128) * 128, args.decoder_dim)
    if not isinstance(head, dict) or "_resident" in head_model.params \
            or tuple(head["weight_q"].shape) != shape:
        raise AssertionError(f"the int8 audio head is not {shape}")
    heads = [{k: v[i] for k, v in head.items()} for i in range(n_heads)]
    gen = torch.Generator(device=model.device).manual_seed(SEED + 130)
    err = max(kernel1_case("int8 audio head", heads[i], rows, gen)
              for i in (0, n_heads - 1) for rows in (1, 64))
    timing = {rows: kernel1_timing("int8 audio head", heads, rows, gen)
              for rows in (1, 64)}
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    ab = captured_vs_eager(
        lambda eager, n: generate_tokens(head_model, prompt, mask, n,
                                         temperature=0.0, _eager_step=eager),
        "int8 audio head", 20, eager_runs=1)
    if ab["counts"]["resident_decode_frame"]:
        raise AssertionError("the int8-head model took kernel 3")
    frames = 10
    steps = {"raw": replay_step(dispatched, 2 * frames),
             "int8": replay_step(head_model, 2 * frames)}
    runs: dict = {"raw": [], "int8": []}
    for name in ("raw", "int8", "int8", "raw"):
        runs[name].append(time_replays(steps[name], frames))
    del steps
    ms = {k: [r["ms"] for r in v] for k, v in runs.items()}
    with_head = runs["int8"][0]["counts"]["w8a8_matvec"]
    without = runs["raw"][0]["counts"]["w8a8_matvec"]
    trace = profile_frames(head_model, "trace, int8 audio head")
    cap, raw_cap = trace["captured"], disp["trace"]["captured"]
    log(f"int8 audio head ({card_info()}): {frames} replayed frames a run, "
        f"alternated raw/int8/int8/raw: device ms a frame int8 head "
        f"{', '.join(f'{t:.3f}' for t in ms['int8'])}, raw head "
        f"{', '.join(f'{t:.3f}' for t in ms['raw'])}; profiled captured "
        f"frame: int8 head {cap['events']:.0f} events, {cap['busy_ms']:.3f}"
        f" ms busy; raw head {raw_cap['events']:.0f} events, "
        f"{raw_cap['busy_ms']:.3f} ms busy; whole 20-frame calls (prefill "
        f"and eager first frame included) {ab['ms_captured']:.2f} ms a "
        f"frame captured, {ab['ms_eager']:.2f} eager; kernel-1 launches a "
        f"replayed frame {with_head:.0f}, with the raw head {without:.0f}: "
        f"{with_head - without:.0f} head launches a frame (need {n_heads})")
    if with_head - without != n_heads:
        raise AssertionError("the int8 head is not one kernel-1 launch a "
                             "codebook")
    return dict(kernel1=dict(max_abs_err=err, **timing[1]),
                kernel1_64=timing[64], counts=ab["counts"],
                head_launches=with_head - without,
                ms_replayed=ms, trace=trace,
                ms_per_frame=ab["ms_captured"], ms_eager=ab["ms_eager"])


def c0_logits(model: CSM, prompt, mask) -> torch.Tensor:
    """codebook 0's logits after one backbone prefill of the prompt."""
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    run = prefill_runner(model, tokens, masks, pad, bucket + 1)
    with torch.no_grad():
        return linear(model.params["codebook0_head"], run()).float()


def run_cli(dev, mimi: Mimi, workdir: str) -> dict:
    """The `generate` and `finetune` commands, their flags parsed by
    `build_parser()`, `mimi` installed as the codec singleton and the text
    tokenizer replaced, on a random bf16 CSM-1B (SEED + 7) saved with
    `save_weights`: `generate -w <that file> --temperature 0` run as the
    command runs it (`args.func`: the checkpoint loaded onto the card,
    not quantized, so the dispatched decoder with the raw head; gate: its
    WAV equals the one of a direct `generate` call on the checkpoint
    loaded again); `finetune convert` of two `smoke_wave` turns; one
    `finetune lora sft` step at batch 1 on that JSON, on the saved model
    in hand (`lora_finetune.train`; gates: a finite loss;
    `adapter_config.json` and `adapters.safetensors` written;
    `load_adapters` into the loaded checkpoint gives the trained model's
    codebook-0 logits on one prompt within bf16 noise, 2**-7 of their
    largest magnitude)."""
    from csm_mlx_tpu_torch import tokenizers as port_tokenizers
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.finetune import lora_finetune
    from csm_mlx_tpu_torch.loaders import load_csm_weights
    from csm_mlx_tpu_torch.ops.sampling import make_sampler
    from csm_mlx_tpu_torch.utils.audio import write_audio

    text = "The quick brown fox jumps over the lazy dog."
    t0 = time.perf_counter()
    trained = random_csm(csm_1b(), torch.bfloat16, dev, SEED + 7)
    ckpt = os.path.join(workdir, "csm-1b.safetensors")
    trained.save_weights(ckpt)
    log(f"CSM-1B random init (seed {SEED + 7}, bf16) saved to a "
        f"{os.path.getsize(ckpt) / 2**30:.2f} GiB checkpoint: "
        f"{time.perf_counter() - t0:.1f} s")
    key = (trained.n_audio_codebooks,
           str(port_tokenizers._codec_device(trained.device)))
    saved = port_tokenizers._MIMI_CACHE.get(key)
    port_tokenizers._MIMI_CACHE[key] = (None, mimi)
    out: dict = {}
    try:
        with with_text_rows(trained):
            wav = os.path.join(workdir, "cli.wav")
            args = build_parser().parse_args(
                ["generate", text, "-w", ckpt, "--temperature", "0", "-l",
                 "2000", "-o", wav])
            reset_counts()
            t0 = time.perf_counter()
            args.func(args)
            torch.cuda.synchronize()
            t_cli = time.perf_counter() - t0
            counts = read_counts()
            loaded = CSM(trained.args, params=load_csm_weights(ckpt,
                                                               device=dev))
            direct = generation.generate(
                loaded, text, 0, (), 2000,
                sampler=make_sampler(temp=0.0, top_k=50))
            want = os.path.join(workdir, "direct.wav")
            write_audio(direct.float().cpu().numpy(), want, 24000)
            with open(wav, "rb") as f, open(want, "rb") as g:
                same = f.read() == g.read()
            n = direct.numel() // 1920
            log(f"CLI generate -w <checkpoint> --temperature 0 -l 2000 "
                f"({card_info()}): {n} frames, {t_cli:.2f} s with the "
                f"checkpoint's load; the WAV equals a direct generate "
                f"call's on the checkpoint loaded again: {same}; launches "
                f"{counts} (bf16, not quantized: no kernel of the "
                f"slice's path)")
            if not (same and n >= 1 and direct.numel() == n * 1920
                    and direct.device.type == "cuda"):
                raise AssertionError("the CLI's WAV is not generate's")
            out["generate"] = dict(counts=counts, seconds=t_cli, frames=n)

            src = os.path.join(workdir, "conversations", "conv1")
            os.makedirs(src)
            for i, name in enumerate(("turn1_speaker0", "turn2_speaker1")):
                write_audio(smoke_wave(2.0, SEED + 140 + i),
                            os.path.join(src, f"{name}.wav"), 24000)
                with open(os.path.join(src, f"{name}.txt"), "w") as f:
                    f.write(f"Turn {i + 1} of the smoke conversation.\n")
            data = os.path.join(workdir, "data.json")
            args = build_parser().parse_args(
                ["finetune", "convert", os.path.dirname(src), data])
            args.func(args)
            with open(data) as f:
                convs = json.load(f)
            if [[t["speaker"] for t in c] for c in convs] != [[0, 1]]:
                raise AssertionError(f"finetune convert wrote {convs}")

            run_dir = os.path.join(workdir, "lora")
            args = build_parser().parse_args(
                ["finetune", "lora", "sft", "--data-path", data, "-o",
                 run_dir, "--batch-size", "1", "--epochs", "1",
                 "--log-freq", "1", "--ckpt-freq", "0", "--lr", "1e-3"])
            reset_counts()
            t0 = time.perf_counter()
            lora_finetune.train(args, trained)
            torch.cuda.synchronize()
            t_sft = time.perf_counter() - t0
            sft_counts = read_counts()
        with open(os.path.join(run_dir, "trainer_state.json")) as f:
            losses = [r["loss"] for r in json.load(f)["history"]]
        files = sorted(os.listdir(run_dir))
        prompt, mask = synthetic_prompt(32, trained.args.n_text_vocab, SEED)
        want_logits = c0_logits(trained, prompt, mask)
        loaded.frame_steps.clear()
        lora.load_adapters(loaded, run_dir)
        got_logits = c0_logits(loaded, prompt, mask)
        diff = (got_logits - want_logits).abs().max().item()
        tol = 2.0 ** -7 * want_logits.abs().max().item()
        log(f"CLI finetune convert + lora sft ({card_info()}): "
            f"{len(convs[0])} turns, {len(losses)} step(s), loss {losses}, "
            f"{t_sft:.2f} s; wrote {files}; reloaded adapters' c0 logits vs "
            f"the trained model's: max |diff| {diff:.3e} (tol {tol:.3e}); "
            f"launches {sft_counts}")
        if not (len(losses) == 1 and np.isfinite(losses[0])
                and {"adapter_config.json", "adapters.safetensors"}
                <= set(files) and diff <= tol):
            raise AssertionError("the LoRA SFT step's adapters do not "
                                 "reload to the trained model")
        out["sft"] = dict(loss=losses[0], seconds=t_sft, diff=diff)
        del trained, loaded
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            port_tokenizers._MIMI_CACHE.pop(key, None)
        else:
            port_tokenizers._MIMI_CACHE[key] = saved
    return out


# ---------------------------------------------------------------------------
# The voice chat, the int8 codec, the profiling hooks
# ---------------------------------------------------------------------------


class TurnSTT:
    """The scripted STT: one utterance a turn, given once a turn's second
    of speech (16,000 samples) has come in."""

    def __init__(self, utterances):
        self.utterances = list(utterances)
        self.total = 0

    def insert_audio_chunk(self, chunk):
        self.total += len(chunk)

    def process_iter(self):
        if self.total >= 16000 and self.utterances:
            self.total = 0
            return self.utterances.pop(0)
        return ""

    def finish(self):
        return ""


def scripted_llm(replies):
    """The scripted streaming LLM (the app's `LLMBackend` contract): turn
    i's reply as an iterator of 9-character text chunks."""
    def llm(messages):
        turn = sum(m["role"] == "user" for m in messages) - 1
        text = replies[turn]
        return iter([text[i:i + 9] for i in range(0, len(text), 9)])

    return llm


class VoiceRecorder:
    """What a voice-chat session does on the card, by sentence and by turn:
    a TTS function wrapping `build_tts_stream_fn`'s that records each
    sentence's context rows, the ms of its prompt's assembly (the context
    encodes; `generation._assemble_prompt`, timed between two
    synchronizes), its first chunk's latency, the frames it made, its
    launch counts and whether it built a new frame step; and the played
    chunks' times (`play`)."""

    def __init__(self, model: CSM, tts):
        self.model, self.tts = model, tts
        self.sentences: list = []
        self.play_times: list = []
        self._assemble = None

    def __enter__(self):
        self._assemble = generation._assemble_prompt

        def assemble(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prompt, mask = self._assemble(*a, **kw)
            torch.cuda.synchronize()
            cur = self.sentences[-1]
            cur["rows"] = prompt.shape[0]
            cur["assemble_ms"] = 1e3 * (time.perf_counter() - t0)
            return prompt, mask

        generation._assemble_prompt = assemble
        return self

    def __exit__(self, *exc):
        generation._assemble_prompt = self._assemble

    def __call__(self, text, speaker, context):
        rec = dict(text=text, context=len(context), chunks=0, done=False)
        self.sentences.append(rec)
        keys = set(self.model.frame_steps)
        inner = self.tts(text, speaker, context)

        def stream():
            before = read_counts()
            t0 = time.perf_counter()
            try:
                for chunk in inner:
                    if rec["chunks"] == 0:
                        rec["first_ms"] = 1e3 * (time.perf_counter() - t0)
                    rec["chunks"] += 1
                    yield chunk
                rec["done"] = True
            finally:
                inner.close()
                after = read_counts()
                rec["counts"] = {k: after[k] - before[k] for k in after}
                rec["new_step"] = bool(set(self.model.frame_steps) - keys)

        return stream()

    def frames(self, rec, max_frames: int) -> int:
        """Frames a sentence made: one a chunk, and one more when the
        stream stopped before its last frame (an EOS frame is not sent; a
        closed stream had launched its next frame)."""
        return rec["chunks"] + (rec["chunks"] < max_frames)


def timed_audio(recorder: VoiceRecorder):
    """`NullAudioIO` that also records the host time of each played
    chunk."""
    from csm_mlx_tpu_torch.apps.voice_chat import NullAudioIO

    class TimedAudio(NullAudioIO):
        def play(self, chunk):
            recorder.play_times.append(time.perf_counter())
            super().play(chunk)

    return TimedAudio()


def voice_session(model: CSM, mimi: Mimi, replies, wav_path: str,
                  barge_in: bool) -> dict:
    """One `VoiceChatPipeline` session on `model` with `mimi`: the scripted
    STT (a turn's utterance once its second of speech is in) and streaming
    LLM (`replies`, one a turn), `build_tts_stream_fn` with the app's
    sampler defaults and one seeded generator, the session WAV at
    `wav_path`. Each turn feeds one second of loud speech (4 chunks of
    0.25 s) once the bot is quiet and its cooldown over, and waits for the
    reply's sentences; with `barge_in`, the last turn's speech comes while
    the bot speaks its first sentence (one loud chunk after its first
    played chunk). Returns the recorder, the turns' feed times, the played
    chunks, the barge-in's chunk count and the logged warnings."""
    import asyncio
    import logging

    from csm_mlx_tpu_torch.apps import voice_chat as vc
    from csm_mlx_tpu_torch.apps.voice_chat import (VoiceChatPipeline,
                                                   build_tts_stream_fn,
                                                   split_sentences)

    gen = torch.Generator(device=model.device).manual_seed(SEED + 500)
    tts = build_tts_stream_fn(model, sampler=VOICE_SAMPLER,
                              max_audio_length_ms=VOICE_SENTENCE_MS,
                              mimi=mimi, generator=gen)
    warnings_seen: list = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings_seen.append(record.getMessage())

    catch = Catch(level=logging.WARNING)
    vc.logger.addHandler(catch)
    recorder = VoiceRecorder(model, tts)
    audio = timed_audio(recorder)
    turns = len(replies)
    utterances = [f"Question number {i} for you?" for i in range(turns)]
    pipe = VoiceChatPipeline(TurnSTT(utterances), scripted_llm(replies),
                             recorder, audio, output_file=wav_path)
    state = pipe.state
    expected = [len(split_sentences(r)) for r in replies]
    out = dict(feeds=[], barge=None)

    async def quiet():
        while (state.tts_speaking or not state.llm_out_q.empty()
               or time.monotonic() < state.cooldown_until + 0.1):
            await asyncio.sleep(0.01)

    async def speak():
        for i in range(4):
            audio.feed(np.full(4000, 0.2, dtype=np.float32))
            t_fed = time.perf_counter()
            await asyncio.sleep(0.02)
        return t_fed

    async def scenario():
        run = asyncio.create_task(pipe.run_async())
        while audio._on_input is None:  # the pipeline has started
            await asyncio.sleep(0.01)
        try:
            for turn in range(turns):
                deadline = time.perf_counter() + VOICE_TURN_S
                await quiet()
                n_before = len(recorder.sentences)
                out["feeds"].append((await speak(), len(audio.played)))
                if barge_in and turn == turns - 1:
                    while len(audio.played) == out["feeds"][-1][1]:
                        assert time.perf_counter() < deadline, \
                            "the barge-in turn never spoke"
                        await asyncio.sleep(0.002)
                    played = len(audio.played)
                    audio.feed(np.full(4000, 0.2, dtype=np.float32))
                    while state.tts_speaking or \
                            not recorder.sentences[-1].get("counts"):
                        assert time.perf_counter() < deadline, \
                            "the interrupted turn did not stop"
                        await asyncio.sleep(0.01)
                    await asyncio.sleep(1.0)  # stragglers are discarded
                    out["barge"] = dict(
                        at=played, after=len(audio.played) - played,
                        spoken=len(recorder.sentences) - n_before)
                    continue
                while len(recorder.sentences) < n_before + expected[turn] \
                        or not recorder.sentences[-1].get("counts") \
                        or state.tts_speaking:
                    assert time.perf_counter() < deadline, \
                        f"turn {turn} did not finish"
                    await asyncio.sleep(0.01)
        finally:
            state.shutdown.set()
            await run

    try:
        with recorder:
            asyncio.run(scenario())
    finally:
        vc.logger.removeHandler(catch)
    out.update(recorder=recorder, played=list(audio.played),
               warnings=warnings_seen, state=state)
    return out


def wav_pcm(path: str) -> np.ndarray:
    import wave

    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def check_voice_session(label: str, s: dict, wav_path: str,
                        max_frames: int) -> dict:
    """Log a session's turns and sentences and gate it: the WAV is the
    played chunks (on the 16-bit grid: every sample within one step), no
    TTS failure or timeout was logged, kernel 3 launched once a frame where
    the model has its tables."""
    rec, times = s["recorder"], s["recorder"].play_times
    played = np.concatenate(s["played"])
    pcm = wav_pcm(wav_path).astype(np.float64) / 32767.0
    wav_ok = pcm.shape == played.shape and bool(
        np.abs(pcm - np.clip(played, -1, 1)).max() <= 1.0 / 32767 + 1e-7)
    lines = []
    for i, (t_fed, n_played) in enumerate(s["feeds"]):
        after = [t for t in times[n_played:]]
        end = s["feeds"][i + 1][1] if i + 1 < len(s["feeds"]) else len(times)
        turn_times = times[n_played:end]
        gap = max(np.diff(turn_times), default=0.0) * 1e3
        v2v = (after[0] - t_fed) * 1e3 if after else float("nan")
        lines.append(f"turn {i}: voice-to-voice {v2v:.1f} ms, "
                     f"{len(turn_times)} chunks, largest gap between played "
                     f"chunks {gap:.1f} ms")
    for r in rec.sentences:
        c = r.get("counts", {})
        lines.append(
            f"  sentence {r['text'][:28]!r}: context {r['context']} "
            f"segments, {r.get('rows')} prompt rows, prompt assembly "
            f"(context encodes) {r.get('assemble_ms', 0):.1f} ms, first "
            f"chunk {r.get('first_ms', float('nan')):.1f} ms, "
            f"{r['chunks']} chunks, new frame step {r.get('new_step')}, "
            f"kernels 1/2/3/5 {c.get('w8a8_matvec')}/"
            f"{c.get('flash_prefill_sdpa')}/{c.get('resident_decode_frame')}"
            f"/{c.get('affine_matvec')}")
    steps = list(rec.model.frame_steps.values())
    kept = sum(st.cache.k.nbytes + st.cache.v.nbytes for st in steps)
    log(f"{label} ({card_info()}): " + "\n  ".join(lines)
        + f"\n  kept frame steps {len(steps)} "
        f"{[(st.cache.k.shape[1], st.cache.capacity) for st in steps]}, "
        f"their KV caches {kept / 2 ** 20:.1f} MiB; session WAV "
        f"{len(pcm)} samples equal to the {len(s['played'])} played chunks "
        f"on the 16-bit grid {wav_ok}; warnings logged {s['warnings']}")
    if not wav_ok:
        raise AssertionError(f"{label}: the session WAV is not the played "
                             f"chunks")
    bad = [w for w in s["warnings"]
           if "TTS failed" in w or "TTS generation timeout" in w
           or "LLM" in w]
    if bad:
        raise AssertionError(f"{label}: the pipeline logged {bad}")
    if any(len(c) != 1920 for c in s["played"]):
        raise AssertionError(f"{label}: a played chunk is not 1,920 samples")
    for r in rec.sentences:
        if "_resident" in rec.model.params and \
                r["counts"]["resident_decode_frame"] != rec.frames(
                    r, max_frames):
            raise AssertionError(f"{label}: sentence {r['text']!r} made "
                                 f"{rec.frames(r, max_frames)} frames and "
                                 f"{r['counts']['resident_decode_frame']} "
                                 f"kernel-3 launches")


def run_voice_chat(model: CSM, mimi: Mimi, workdir: str) -> dict:
    """The voice chat at full CSM-1B width on the card: a
    `VoiceChatPipeline` on the W8A8 model (kernel-3 tables) with Mimi(32),
    the app's sampler (T 0.6, top-k 50, top-p 1.0, min-p 0.05) through
    `build_tts_stream_fn`, `NullAudioIO` fed from numpy, the scripted STT
    and streaming LLM, the text tokenizer replaced (`with_text_rows`):
    three turns of three sentences (the context window fills and rolls at
    6 segments; the prompts reach >= 256 rows: kernel 1's GEMM route and
    kernel 2 in their prefill), then a turn interrupted by loud input while
    the bot speaks (gate: playback ends within FADE_CHUNKS chunks, the
    reply's other sentences are discarded). Then one turn on CSM-1B affine
    4-bit g64, the app's default quantization (gate: kernel 5 on every
    quantized linear of its frames; kernels 1 and 3 never). Per turn the
    voice-to-voice latency (the last loud chunk fed to the first chunk
    played); per sentence the first chunk's latency, the context rows, the
    ms of the prompt's assembly (the context encodes), whether it built a
    new frame step."""
    from csm_mlx_tpu_torch.apps.voice_chat import FADE_CHUNKS, split_sentences

    max_frames = VOICE_SENTENCE_MS // 80
    model.frame_steps.clear()
    with with_text_rows(model):
        wav = os.path.join(workdir, "voice_w8a8.wav")
        s = voice_session(model, mimi, VOICE_REPLIES, wav, barge_in=True)
        check_voice_session("voice chat, CSM-1B W8A8 + Mimi(32)", s, wav,
                            max_frames)
        rec = s["recorder"]
        rows = [r.get("rows", 0) for r in rec.sentences]
        contexts = [r["context"] for r in rec.sentences]
        segs = s["state"].context_segments
        long = [r for r in rec.sentences if r.get("rows", 0) >= 256]
        barge = s["barge"]
        log(f"voice chat: {len(rec.sentences)} sentences, context segments "
            f"a sentence {contexts}, prompt rows {rows}; kept context "
            f"{len(segs)} segments; barge-in at played chunk {barge['at']}: "
            f"{barge['after']} chunks played after it (FADE_CHUNKS "
            f"{FADE_CHUNKS}), {barge['spoken']} of "
            f"{len(split_sentences(VOICE_REPLIES[-1]))} sentences of that "
            f"reply spoken")
        if max(contexts) != 6 or len(segs) != 6 or not long:
            raise AssertionError("the context did not fill its 6 segments "
                                 "or no prompt reached 256 rows")
        if any(r["counts"]["flash_prefill_sdpa"] != 16 for r in long) or \
                not all(r["counts"]["w8a8_matvec.gemm"] for r in long):
            raise AssertionError("a >= 256-row prompt did not run kernel 2 "
                                 "and kernel 1's GEMM route in its prefill")
        if barge["after"] > FADE_CHUNKS + 1 or barge["spoken"] != 1:
            raise AssertionError("the barge-in did not fade out and discard "
                                 "the rest of the reply")
        w8a8_counts = {k: sum(r["counts"][k] for r in rec.sentences)
                       for k in rec.sentences[0]["counts"]}
        model.frame_steps.clear()

        args = model.args
        affine = random_csm(args, torch.bfloat16, model.device, SEED)
        quant.quantize_model(affine, bits=4, group_size=64, mode="affine")
        p = affine.params
        backbone = quantized_linears(p["backbone"])
        per_frame = backbone + (args.n_audio_codebooks - 1) * (
            quantized_linears(p["decoder"])
            + quantized_linears(p["projection"]))
        wav = os.path.join(workdir, "voice_affine.wav")
        s = voice_session(affine, mimi, (VOICE_AFFINE_REPLY,), wav,
                          barge_in=False)
        check_voice_session("voice chat, CSM-1B affine 4-bit g64 + Mimi(32)",
                            s, wav, max_frames)
        arec = s["recorder"]
        frames = sum(arec.frames(r, max_frames) for r in arec.sentences)
        counts = {k: sum(r["counts"][k] for r in arec.sentences)
                  for k in arec.sentences[0]["counts"]}
        # the first frame decodes the prefill's last hidden state (no
        # backbone step); a prefill of <= 64 rows runs kernel 5, a longer
        # one the dequantized weights, as in JAX
        want = sum(arec.frames(r, max_frames) * per_frame - backbone
                   + (backbone if r["rows"] <= quant.AFFINE_MAX_ROWS else 0)
                   for r in arec.sentences)
        log(f"voice chat, affine turn: {frames} frames, launches {counts}; "
            f"kernel 5 {counts['affine_matvec']}, {per_frame} a frame "
            f"({backbone} in the backbone step) and {backbone} a prefill of "
            f"<= {quant.AFFINE_MAX_ROWS} rows make {want}")
        if counts["w8a8_matvec"] or counts["resident_decode_frame"] or \
                counts["affine_matvec"] != want:
            raise AssertionError("the affine turn did not run kernel 5 alone "
                                 "on every quantized linear of its frames")
        del affine
        torch.cuda.empty_cache()
    return dict(counts=w8a8_counts, affine_counts=counts)


def codec_conv_inputs(dec: dict, cfg, t25: int):
    """(conv params, dilation, input length, transposed) of every SEANet
    decoder conv, in decode order, at the lengths a chunk of `t25` frames
    at 25 Hz gives them (the causal left pads included)."""
    from csm_mlx_tpu_torch.models.mimi import conv as mconv
    from csm_mlx_tpu_torch.models.mimi.conv import causal_pad_amount

    out = []
    t = t25

    def add(p, dilation=1):
        k = mconv._weight(p).shape[-1]
        out.append((p, dilation, t + causal_pad_amount(k, 1, dilation),
                    False))

    add(dec["init"])
    for stage, ratio in zip(dec["stages"], cfg.upsampling_ratios):
        out.append((stage["up"], 1, t, True))
        t *= ratio
        for j, block in enumerate(stage["residual"]):
            add(block["conv1"], cfg.dilation_growth_rate ** j)
            add(block["conv2"])
    add(dec["final"])
    return out


def run_int8_codec(model: CSM, mimi: Mimi, frames_125: np.ndarray) -> dict:
    """The int8 Mimi decode on the card (`models/mimi/quant.py` on a copy
    of Mimi(32)): the main path's 125 frames decoded int8, batch and
    streamed frame by frame, against fp32 (gate: relative RMSE <
    CODEC_BATCH_RMSE, JAX's bound), and the first 6 streamed against their
    int8 batch decode (JAX's case; gate: within CODEC_CPU_SHARE of the
    same on the CPU copy, printed beside JAX's tiny-codec bound); each
    int8 conv's int32 sums (one `torch._int_mm`) bit-equal to its plain
    version on the CPU at the engine block's lengths, timed against the
    fp32 conv at 64 rows; kernel 1 on the codec transformer's linears
    against its plain version at 2, 128 and 1,024 rows; the engine at its
    defaults (64 slots, K = 8) with `quantize_codec` on and off, alternated
    on/off/off/on (gates: the same frames, audio within CODEC_ENGINE_RMSE,
    the int8 convs launched), ms a block and the Mimi part of its eager
    block; and `serve --continuous --quantize-codec` through `make_server`,
    one request. A slower int8 codec is a finding, not a failure."""
    import asyncio

    from csm_mlx_tpu_torch import tokenizers as port_tokenizers
    from csm_mlx_tpu_torch.cli.application import build_parser
    from csm_mlx_tpu_torch.cli.serve import make_server
    from csm_mlx_tpu_torch.models.mimi import conv as mconv
    from csm_mlx_tpu_torch.models.mimi.quant import (
        mimi_decoder_is_quantized, quantize_mimi_decoder)

    dev = model.device
    card = card_info()
    qmimi = Mimi(mimi.cfg, params=map_params(lambda t: t, mimi.params),
                 device=dev)
    quantize_mimi_decoder(qmimi)
    if mimi_decoder_is_quantized(mimi.params):
        raise AssertionError("quantizing the copy touched the codec")

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).pow(2).mean().sqrt()
                / (b.pow(2).mean().sqrt() + 1e-12)).item()

    codes = torch.from_numpy(frames_125.T[None].copy()).to(dev)

    def streamed(codec, c):
        state = codec.init_decode_state(1)
        chunks = []
        for i in range(c.shape[-1]):
            chunk, state = codec.decode_step(c[:, :, i:i + 1], state)
            chunks.append(chunk)
        return torch.cat(chunks, dim=-1)

    reset_counts()
    want = mimi.decode(codes)
    got = qmimi.decode(codes)
    batch_counts = read_counts()
    stream = streamed(qmimi, codes)
    # JAX's streamed-against-batched case decodes 6 frames; the same on the
    # CPU copy of the int8 codec, whose arithmetic the CPU tests hold to
    # JAX's (tests/test_torch_mimi_quant.py, also at this codec's size)
    short = codes[:, :, :CODEC_STREAM_FRAMES]
    r_batch, r_stream = rel(got, want), rel(stream, want)
    r_short = rel(streamed(qmimi, short), qmimi.decode(short))
    cpu_q = Mimi(mimi.cfg, params=params_to_cpu(qmimi.params), device="cpu")
    r_cpu = rel(streamed(cpu_q, short.cpu()), cpu_q.decode(short.cpu()))
    log(f"int8 Mimi(32) decode ({card}): 125 frames, relative RMSE "
        f"against fp32 {r_batch:.4f} batch, {r_stream:.4f} streamed frame "
        f"by frame (bound {CODEC_BATCH_RMSE}); streamed against batched "
        f"{rel(stream, got):.4f} over 125 frames (each batch row's "
        f"activation scale spans the 10 s), {r_short:.4f} over "
        f"{CODEC_STREAM_FRAMES} (the same on the CPU {r_cpu:.4f}; JAX's "
        f"tiny-codec bound {CODEC_STREAM_RMSE}); launches in the batch "
        f"decode { {k: v for k, v in batch_counts.items() if v} }")
    if not (torch.isfinite(got).all() and r_batch < CODEC_BATCH_RMSE
            and r_stream < CODEC_BATCH_RMSE
            and abs(r_short - r_cpu) <= CODEC_CPU_SHARE * r_cpu):
        raise AssertionError("the int8 decode is outside JAX's bound, or "
                             "its stream differs from the CPU's")

    gen = torch.Generator(device=dev).manual_seed(SEED + 600)
    conv_lines, all_equal = [], True
    qconvs = codec_conv_inputs(qmimi.params["decoder"], mimi.cfg,
                               2 * SERVE_K)
    fconvs = codec_conv_inputs(mimi.params["decoder"], mimi.cfg, 2 * SERVE_K)
    for (qp, dil, t, transposed), (fp, *_) in zip(qconvs, fconvs):
        c_in = qp["weight_q"].shape[0 if transposed else 1]
        xq = torch.randint(-127, 128, (CODEC_CONV_ROWS, c_in, t),
                           generator=gen, device=dev).to(torch.int8)
        if transposed:
            sums = mconv.int8_conv_transpose1d_sums(xq, qp["weight_q"], 1)
            plain = mconv.int8_conv_transpose1d_sums_plain(
                xq.cpu(), qp["weight_q"].cpu(), 1)
        else:
            sums = mconv.int8_conv1d_sums(xq, qp["weight_q"], 1, dil)
            plain = mconv.int8_conv1d_sums_plain(xq.cpu(), qp["weight_q"].cpu(),
                                                 1, dil)
        equal = torch.equal(sums.cpu(), plain)
        all_equal &= equal
        x = torch.randn((SERVE_SLOTS, c_in, t), generator=gen, device=dev)
        fn = mconv.conv_transpose1d if transposed else mconv.conv1d
        kw = {} if transposed else dict(dilation=dil)
        ms_q = time_ms(lambda: fn(qp, x, **kw))[0]
        ms_f = time_ms(lambda: fn(fp, x, **kw))[0]
        conv_lines.append(
            f"{'convtr' if transposed else 'conv'} "
            f"{tuple(qp['weight_q'].shape)} T={t}: sums bit-equal {equal}, "
            f"64 rows int8 {ms_q:.3f} ms, fp32 {ms_f:.3f} ms")
    log(f"int8 SEANet convs (int32 sums of one torch._int_mm against the "
        f"plain float64 conv on the CPU, {CODEC_CONV_ROWS} rows; timed at "
        f"{SERVE_SLOTS} rows, quantization and fix-up included, against "
        f"the fp32 cuDNN conv, TF32 off): " + "; ".join(conv_lines))
    if not all_equal:
        raise AssertionError("an int8 conv's sums differ from its plain "
                             "version's")

    lin_lines, lin_ok = [], True
    layer = qmimi.params["decoder_transformer"]["layers"][0]
    for name, q in (("q_proj", layer["self_attn"]["q_proj"]),
                    ("fc1", layer["mlp"]["fc1"]),
                    ("fc2", layer["mlp"]["fc2"])):
        for rows in (2, 128, 1024):
            x = torch.randn((rows, q["weight_q"].shape[1]), generator=gen,
                            device=dev)
            err, scale, routed, ok = kernel1_vs_plain(x, q)
            lin_ok &= ok
            ms = time_ms(lambda: quant.w8a8_matvec(
                x, q["weight_q"], q["scales"], q["biases"]))[0]
            lin_lines.append(f"{name} {tuple(q['weight_q'].shape)} {rows} "
                             f"rows fp32 {'[tensor cores]' if routed else '[matvec]'}"
                             f": max_abs_err {err:.2e} of {scale:.2e} ok {ok}, "
                             f"{1e3 * ms:.1f} us")
    log("kernel 1 on the int8 codec's transformer linears: "
        + "; ".join(lin_lines))
    if not lin_ok:
        raise AssertionError("kernel 1 disagrees with its plain version on "
                             "the codec's linears")

    prompts = [synthetic_prompt(32, model.args.n_text_vocab, SEED + 700 + i)
               for i in range(SERVE_SLOTS)]
    engines = {q: serving_engine(model, mimi, SEED + 701, max_frames=
                                 SERVE_AB_CAP, quantize_codec=q)
               for q in (True, False)}
    runs: dict = {True: [], False: []}
    for q in (True, False, False, True):
        reset_counts()
        frames, audio, ms = engine_ab_run(engines[q], prompts,
                                          CODEC_AB_FRAMES)
        runs[q].append(dict(frames=frames, audio=audio, ms=ms,
                            counts=read_counts(),
                            blocks=engines[q].stats.steps))
    same = all(np.array_equal(a, b) for a, b in zip(runs[True][0]["frames"],
                                                    runs[False][0]["frames"]))
    rmse = float(np.mean([rel(torch.from_numpy(a), torch.from_numpy(b))
                          for a, b in zip(runs[True][0]["audio"],
                                          runs[False][0]["audio"])]))
    qc = runs[True][0]["counts"]
    int8_convs = qc["int8_conv1d_sums"] + qc["int8_conv_transpose1d_sums"]
    split = {q: block_split(serving_engine(model, mimi, SEED + 702,
                                           max_frames=SERVE_AB_CAP,
                                           quantize_codec=q, eager=True),
                            prompts) for q in (True, False)}
    log(f"engine, 64 slots, K={SERVE_K}, {CODEC_AB_FRAMES} frames a request "
        f"({card}), int8 codec on/off alternated on/off/off/on: ms a block "
        f"on {', '.join(f'{r['ms']:.2f}' for r in runs[True])}, off "
        f"{', '.join(f'{r['ms']:.2f}' for r in runs[False])}; frames equal "
        f"{same}; audio relative RMSE on against off {rmse:.4f} (bound "
        f"{CODEC_ENGINE_RMSE}); int8 conv GEMMs {int8_convs}, kernel-1 "
        f"launches {qc['w8a8_matvec']} (off: "
        f"{runs[False][0]['counts']['w8a8_matvec']}) in the first on run; "
        f"eager block by part on: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split[True].items())
        + " ms; off: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split[False].items())
        + " ms")
    if not same or not rmse < CODEC_ENGINE_RMSE or not int8_convs:
        raise AssertionError("the int8-codec engine's frames or audio are "
                             "off, or its int8 convs did not run")
    del engines
    torch.cuda.empty_cache()

    key = (model.n_audio_codebooks,
           str(port_tokenizers._codec_device(model.device)))
    saved = port_tokenizers._MIMI_CACHE.get(key)
    port_tokenizers._MIMI_CACHE[key] = (None, mimi)

    async def one(srv):
        try:
            return await srv.synthesize("The river was high.")
        finally:
            await srv.stop()

    try:
        with with_text_rows(model):
            srv = make_server(build_parser().parse_args(
                ["serve", "--continuous", "--quantize-codec", "--slots", "8",
                 "--temperature", "0", "--max-audio-length",
                 str(SERVE_HTTP_MS)]), model)
            quantized = mimi_decoder_is_quantized(srv.engine._mimi.params)
            audio = asyncio.run(one(srv))
    finally:
        if saved is None:
            port_tokenizers._MIMI_CACHE.pop(key, None)
        else:
            port_tokenizers._MIMI_CACHE[key] = saved
    log(f"serve --continuous --quantize-codec (make_server): the engine's "
        f"decoder int8 {quantized}, the codec singleton's "
        f"{mimi_decoder_is_quantized(mimi.params)}; one request: "
        f"{len(audio)} samples")
    if not quantized or mimi_decoder_is_quantized(mimi.params) \
            or not len(audio) or len(audio) % 1920 \
            or not np.isfinite(audio).all():
        raise AssertionError("serve --quantize-codec did not serve through "
                             "the int8 codec")
    return dict(block_ms={q: [r["ms"] for r in v] for q, v in runs.items()},
                mimi_ms={q: split[q]["mimi"] for q in split},
                counts=qc)


def run_trace(model: CSM, workdir: str) -> None:
    """`utils.profiling.trace` around PROFILE_FRAMES replayed main-path
    frames inside one `annotate` span. Gate: the Chrome trace it writes
    holds the span and kernels 1 and 3 (kernel 3 once a frame)."""
    import glob

    from csm_mlx_tpu_torch.utils.profiling import annotate, trace

    step = replay_step(model, PROFILE_FRAMES)
    torch.cuda.synchronize()
    logdir = os.path.join(workdir, "trace")
    with padded(trace(logdir)):
        with annotate("chip_smoke replayed frames"):
            for _ in range(PROFILE_FRAMES):
                step()
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    seen = {k: sum(any(n in name for n in kn) for name in names)
            for k, kn in PROFILED_KERNELS.items()}
    span = "chip_smoke replayed frames" in names
    log(f"trace (utils.profiling.trace, {card_info()}): "
        f"{os.path.basename(files[0])}, {len(events)} events, "
        f"{os.path.getsize(files[0]) / 2 ** 20:.1f} MiB; the span "
        f"{span}; kernel launches by name {seen} over {PROFILE_FRAMES} "
        f"replayed frames")
    if len(files) != 1 or not span or not seen["w8a8_matvec"] \
            or seen["resident_decode_frame"] != PROFILE_FRAMES:
        raise AssertionError("the trace lacks the span or kernels 1 and 3")


def async_checkpoints(args, batch: dict, common: dict, optimizer,
                      workdir: str) -> dict:
    """(f) Full SFT (B=2, S=576, remat) on a fresh random CSM-1B with
    `checkpoint_backend="orbax"`: ASYNC_STEPS steps with a save after each
    (the save copies the weights and AdamW state into pinned host buffers
    behind the step and a thread writes them to step_N/orbax, committed
    by a rename: each step after the first runs with the last save in
    flight), then SYNC_STEPS steps whose save is waited for at once. Logs
    ms a step with and without a save in flight and the wall of each
    save() and wait(); keeps the two newest step directories (a save is
    8.7 GB). Then a new trainer on the directory resumes the newest
    committed step. Gate: its weights and optimizer state equal the
    trainer's, which has not stepped since."""
    import shutil

    model = random_csm(args, torch.bfloat16, torch.device("cuda", 0),
                       SEED + 24)
    run_dir = f"{workdir}/async"
    ckpt = dict(common, checkpoint_backend="orbax")
    tr = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                    output_dir=run_dir, **ckpt))
    tr.train_step(batch)  # the first step's allocations
    torch.cuda.synchronize()

    def prune():
        steps = sorted(int(d.name[5:]) for d in
                       __import__("pathlib").Path(run_dir).glob("step_*"))
        for n in steps[:-2]:
            shutil.rmtree(f"{run_dir}/step_{n}")

    def step_and_save(sync: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)  # float(loss): synchronizes
        step_ms = 1e3 * (time.perf_counter() - t0)
        tr.state.step += 1
        t0 = time.perf_counter()
        tr.checkpointer.save()
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        if sync:
            tr.checkpointer.wait()
        wait_ms = 1e3 * (time.perf_counter() - t0)
        prune()
        return step_ms, save_ms, wait_ms

    t_all = time.perf_counter()
    async_runs = [step_and_save(False) for _ in range(ASYNC_STEPS)]
    t0 = time.perf_counter()
    tr.checkpointer.wait()
    last_wait = 1e3 * (time.perf_counter() - t0)
    sync_runs = [step_and_save(True) for _ in range(SYNC_STEPS)]
    wall = time.perf_counter() - t_all
    flat = tree_to_flat(model.params)
    size = sum(t.nbytes for t in flat.values()) + sum(
        v.nbytes for st in tr.optimizer.state.values() for v in st.values()
        if torch.is_tensor(v))
    live_w = {n: t for n, t in tr.trainable}
    live_o = {n: tr.optimizer.state[t] for n, t in tr.trainable}
    t2 = ft.CSMTrainer(ft.TrainArgs(model=model, optimizer=optimizer(),
                                    output_dir=run_dir, **ckpt))
    w_equal = all(torch.equal(t, live_w[n]) for n, t in t2.trainable)
    o_equal = all(torch.equal(t2.optimizer.state[t][k].to(v.device), v)
                  for n, t in t2.trainable for k, v in live_o[n].items())
    log(f"(f) async checkpoints, full SFT CSM-1B bf16 B={TRAIN_B} "
        f"S={TRAIN_S}, {size / 2 ** 30:.2f} GiB a save ({card_info()}): "
        f"steps with the last save in flight (ms step, save(), which "
        f"first waits for the last write): "
        + ", ".join(f"({a:.1f}, {b:.1f})" for a, b, _ in async_runs)
        + f", the last write waited {last_wait:.1f} ms; steps with "
        f"synchronous saves (ms step, save(), wait()): "
        + ", ".join(f"({a:.1f}, {b:.1f}, {c:.1f})" for a, b, c in sync_runs)
        + f"; {wall:.1f} s in all; resumed step {t2.state.step} (newest "
        f"committed {tr.state.step}): weights bit-equal {w_equal}, "
        f"optimizer state bit-equal {o_equal}")
    if t2.state.step != tr.state.step or not w_equal or not o_equal:
        raise AssertionError("the async checkpoint did not resume bit-equal")
    del tr, t2, model, live_w, live_o, flat
    torch.cuda.empty_cache()
    return dict(async_ms=[a for a, _, _ in async_runs[1:]],
                sync_ms=[a for a, _, _ in sync_runs],
                save_ms=[b + c for _, b, c in sync_runs])


def affine_generator(dev) -> torch.Generator:
    """The generator of kernel 5's cases added with its redesign."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 80)
    return gen


def counting_collectives() -> dict:
    """Wrap torch.distributed's all_reduce and all_gather_into_tensor (the
    collectives `ops.tensor_parallel` and the engine call) to count the
    calls made while a CUDA graph is being captured: what a captured graph
    holds. Returns the live counts."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather_into_tensor": 0}
    for name in counts:
        real = getattr(dist, name)

        def wrapped(*a, _real=real, _name=name, **k):
            if torch.cuda.is_current_stream_capturing():
                counts[_name] += 1
            return _real(*a, **k)

        setattr(dist, name, wrapped)
    return counts


def check_tp_in(dev, gen) -> dict:
    """Kernel 1's in-sharded entries against their plain versions and
    timed, at the backbone's o_proj and down_proj shards of a model axis
    of 2 (local IN 1,024 and 4,096, OUT 2,048), at 1 and 64 rows: the
    whole gathered row quantized (`w8a8_quant_rows`: codes bit-equal,
    absmax / 127 within an fp32 ulp, the row sum within fp32 rounding of
    another order), the
    int32 partial of rank 1's columns (`w8a8_partial`, bit-equal; timed
    cycling over code tables past L2, beside the fused kernel 1 on the
    same shard and `torch._int_mm` on the same codes at 64 rows), and the
    fix-up (`w8a8_fixup`, bit-equal in bf16 and fp32)."""
    out = {}
    for name, (in_l, out_d) in TP_IN_SHAPES.items():
        n_tab = max(2, -(-TP_IN_TABLE_BYTES // (in_l * out_d)))
        ws = [torch.randint(-127, 128, (out_d, in_l), generator=gen,
                            device=dev, dtype=torch.int8)
              for _ in range(n_tab)]
        s = torch.rand((out_d, 1), generator=gen, device=dev) * 1e-2
        z = torch.randn((out_d, 1), generator=gen, device=dev) * 1e-2
        for rows in TP_IN_ROWS:
            x = torch.randn((rows, 2 * in_l), generator=gen,
                            device=dev).to(torch.bfloat16)
            qx, aux = quant.w8a8_quant_rows(x)
            qp, auxp = quant.w8a8_quant_rows_plain(x)
            p = quant.w8a8_partial(qx, in_l, ws[0])
            pp = quant.w8a8_partial_plain(qx, in_l, ws[0])
            fix = {dt: (quant.w8a8_fixup(p, aux, s, z, dt),
                        quant.w8a8_fixup_plain(p, aux, s, z, dt))
                   for dt in (torch.bfloat16, torch.float32)}
            torch.cuda.synchronize()
            sum_err = (aux[:, 1] - auxp[:, 1]).abs().max().item()
            # absmax / 127: the kernel divides; the plain version's division
            # by a Python scalar runs on CUDA as a product with the
            # reciprocal, up to one fp32 ulp apart
            scale_err = ((aux[:, 0] - auxp[:, 0]).abs()
                         / auxp[:, 0]).max().item()
            ok = dict(
                quant_rows=torch.equal(qx, qp) and scale_err <= 2.0 ** -23
                and sum_err <= 1e-5 * auxp[:, 1].abs().max().item() + 1e-4,
                partial=torch.equal(p, pp),
                fixup=all(torch.equal(a, b) for a, b in fix.values()))
            it = iter(range(1 << 30))
            x_l = x[:, in_l:].contiguous()
            qx_l = qx[:, in_l:].contiguous()
            ms = dict(
                quant_rows=time_ms(lambda: quant.w8a8_quant_rows(x))[0],
                partial=time_ms(lambda: quant.w8a8_partial(
                    qx, in_l, ws[next(it) % n_tab]))[0],
                fixup=time_ms(lambda: quant.w8a8_fixup(
                    p, aux, s, z, torch.bfloat16))[0],
                fused=time_ms(lambda: quant.w8a8_matvec(
                    x_l, ws[next(it) % n_tab], s, z))[0])
            plain = dict(
                quant_rows=time_ms(lambda: quant.w8a8_quant_rows_plain(x))[0],
                partial=time_ms(lambda: quant.w8a8_partial_plain(
                    qx, in_l, ws[next(it) % n_tab]))[0],
                fixup=time_ms(lambda: quant.w8a8_fixup_plain(
                    p, aux, s, z, torch.bfloat16))[0])
            lib = None
            if rows > 16:  # torch._int_mm needs more than 16 rows
                wts = [w.t() for w in ws]
                lib = time_ms(lambda: torch._int_mm(
                    qx_l, wts[next(it) % n_tab]))[0]
            bounds = dict(
                quant_rows=bound_ms(rows * 2 * in_l * 3 + rows * 8, 0,
                                    "int8"),
                partial=bound_ms(in_l * out_d + rows * in_l
                                 + 4 * rows * out_d,
                                 2 * rows * in_l * out_d, "int8"),
                fixup=bound_ms(rows * out_d * 6 + rows * 8 + out_d * 8, 0,
                               "int8"),
                fused=bound_ms(in_l * out_d + 8 * out_d
                               + rows * (in_l + out_d) * 2,
                               2 * rows * in_l * out_d, "int8"))
            case = f"{name} IN={in_l} (of {2 * in_l}) OUT={out_d} B={rows}"
            for entry in ("quant_rows", "partial", "fixup"):
                b_ms, b_by = bounds[entry]
                log(f"w8a8_{entry} {case} ({card_info()}): "
                    f"{'bit-equal to its plain version' if ok[entry] else 'MISMATCH'}"
                    + (f" (codes; absmax / 127 within {scale_err:.2e} "
                       f"relative, row sums within {sum_err:.2e})"
                       if entry == "quant_rows" else "")
                    + f"; kernel {1e3 * ms[entry]:.2f} us device, plain "
                    f"{1e3 * plain[entry]:.2f} us; bound {1e3 * b_ms:.2f} "
                    f"us ({b_by}) = {b_ms / ms[entry]:.1%} of the kernel"
                    + (f"; torch._int_mm on the same codes "
                       f"{1e3 * lib:.2f} us"
                       if entry == "partial" and lib is not None else ""))
                out.setdefault(entry, []).append(dict(
                    case=case, ok=ok[entry], ms=ms[entry],
                    plain_ms=plain[entry], bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib if entry == "partial" else None,
                    max_abs_err=sum_err if entry == "quant_rows" else 0.0))
            f_ms, f_by = bounds["fused"]
            log(f"w8a8_matvec (fused, for comparison) {case} on the local "
                f"shard: {1e3 * ms['fused']:.2f} us device; bound "
                f"{1e3 * f_ms:.2f} us ({f_by}); the three in-sharded "
                f"entries sum to "
                f"{1e3 * (ms['quant_rows'] + ms['partial'] + ms['fixup']):.2f}"
                f" us")
            if not all(ok.values()):
                raise AssertionError(f"kernel 1's in-sharded entries "
                                     f"disagree at {case}: {ok}")
        del ws
    return out


def mesh_copy(model: CSM) -> CSM:
    """A CSM over a new dict tree of the same tensors, without kernel 3's
    tables: `shard_model` replaces its leaves and leaves `model`'s."""
    params = {k: v for k, v in model.params.items() if k != "_resident"}
    return CSM(model.args, params=map_params(lambda t: t, params),
               dtype=model.dtype)


def mesh_engine_streams(model: CSM, mesh, reqs, **kw) -> tuple:
    """The token streams of `reqs` ((prompt, mask, max_frames)) through a
    greedy ContinuousEngine (K = MESH_K, no codec) on `mesh` (None:
    mesh-less), the wall ms a block over the run (warm-ups and captures
    included), and the device ms of a replayed block (CUDA events around
    each replay; None when no block was replayed). Under a mesh rank 0
    submits and drives, every other rank follows (and returns Nones)."""
    import torch.distributed as dist

    from csm_mlx_tpu_torch.continuous import ContinuousEngine

    eng = ContinuousEngine(
        model, n_slots=kw.pop("n_slots"), frames_per_step=MESH_K,
        max_frames=max(r[2] for r in reqs), max_prompt_bucket=32,
        # the blocks in flight past a row's last frame: the host learns of
        # its end pipeline_depth blocks late
        capacity_slack=4 * MESH_K, codec=False, mesh=mesh,
        generator=torch.Generator(device=model.device).manual_seed(SEED + 7),
        **kw)
    replays = []  # CUDA events around each replayed block
    run_block = eng._run_block

    def timed_block() -> None:
        if not isinstance(eng._graphs.get(eng._cap),
                          torch.cuda.CUDAGraph):
            return run_block()  # eager, or its bucket's warm-up or capture
        replays.append((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)))
        replays[-1][0].record()
        run_block()
        replays[-1][1].record()

    eng._run_block = timed_block
    t0 = time.perf_counter()
    if mesh is not None and dist.get_rank() != 0:
        eng.follow()
        return None, None, None
    handles = [eng.submit_prompt(p, m, max_frames=mf) for p, m, mf in reqs]
    eng.run_until_idle()
    eng.stop()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(eng.stats.steps, 1)
    replay_ms = (float(np.mean([a.elapsed_time(b) for a, b in replays]))
                 if replays else None)
    return [h.wait(0) for h in handles], ms, replay_ms


def frame_step_graph(model: CSM, ref: CSM, counts: dict) -> dict:
    """The captured frame step of the sharded model at B = 1 from the
    32-row prompt: the collectives its capture recorded (`counts`, from
    `counting_collectives`); under the profiler, two replays' device
    kernels whose names say NCCL, memcpy nodes, and kernel 1's launches
    by entry; and ms a replayed frame of it and of the mesh-less `ref`'s
    step, 5 replays each, alternated (mesh-less, mesh, mesh, mesh-less)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt, mask = synthetic_prompt(32, model.args.n_text_vocab, SEED)
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    def frame_step(m):
        st = generation.FrameStep(m, 1, bucket + 32,
                                  SamplerConfig(temperature=0.0), (), None)
        st.first(st.prefill(tokens, masks, pad))
        st()
        return st

    def replays_ms(st, n=5) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            st()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    step = frame_step(model)
    before = dict(counts)
    step()  # the capture
    held = {k: counts[k] - before[k] for k in counts}
    torch.cuda.synchronize()
    with padded(profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])) as prof:
        for _ in range(2):
            step()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    plain = frame_step(ref)
    plain()  # its capture
    ms = {"mesh-less": [], "mesh": []}
    for label in ("mesh-less", "mesh", "mesh", "mesh-less"):
        ms[label].append(replays_ms(plain if label == "mesh-less"
                                    else step))
    return dict(
        ms=ms, captured=held,
        nccl=sum("nccl" in n.lower() for n in names) / 2,
        memcpy=sum("memcpy" in n.lower() for n in names) / 2,
        quant_rows=sum("quant_rows_kernel" in n for n in names) / 2,
        partial=sum("w8a8_matvec_kernel" in n and "true" in n
                    or "w8a8_gemm_kernel" in n and "true" in n
                    for n in names) / 2,
        fixup=sum("w8a8_fixup_kernel" in n for n in names) / 2,
        events=len(names) / 2)


def mesh_c0_logits(model: CSM, prompt, mask) -> torch.Tensor:
    """Codebook 0's logits after one backbone prefill of the prompt, under
    the model's tensor parallelism where it has one."""
    from csm_mlx_tpu_torch.models.csm import codebook0_logits
    from csm_mlx_tpu_torch.ops import tensor_parallel

    args, dev = model.args, model.device
    bcfg = args.backbone_config
    tokens, masks, pad, bucket = generation._pad_prompt(prompt, mask)
    cos, sin = rope_cache_for(bcfg, bcfg.max_position_embeddings, dev)
    with torch.no_grad(), tensor_parallel.scope(tensor_parallel.of(model)):
        cache = KVCache.init(bcfg, 1, bucket, dtype=model.dtype, device=dev)
        h, _ = generation._prefill(
            model.params, args, torch.from_numpy(tokens).long().to(dev),
            torch.from_numpy(masks).long().to(dev),
            torch.from_numpy(pad).long().to(dev), cache, cos, sin)
        return codebook0_logits(model.params, args, h).float()


def layout_probe(dev) -> dict:
    """Whether the card's results for a row or a head depend on the rest of
    the batch: the masked attention (`ops.attention.sdpa`, bf16 inputs,
    B=4, the backbone's 32 heads over 8 kv heads on a 64-slot cache and
    the decoder's 8 over 2 of 128 on 33 slots) on half the heads and on
    half the rows against the same heads and rows of the whole call, a
    bf16 head matmul (2,048 -> 2,051), the fp32 audio head (1,024 ->
    2,051), kernel 1 (2,048 -> 3,072), the 33-slot input sum and the RMS
    norm on 2 of 4 rows, and a 32-row prefill's causal attention on half
    the heads and half the rows: bit-equal or not."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 220)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = randn(4, 32, 1, 64), randn(4, 8, 64, 64), randn(4, 8, 64, 64)
    whole = attention.sdpa(q, k, v, 0.125)
    # the decoder's shape: 8 heads over 2 kv heads of 128, 33 slots
    qd, kd, vd = (randn(4, 8, 1, 128), randn(4, 2, 33, 128),
                  randn(4, 2, 33, 128))
    whole_d = attention.sdpa(qd, kd, vd, 128 ** -0.5)
    x, w = randn(4, 2048), randn(2051, 2048)
    h, head = randn(4, 1024).float(), randn(1024, 2051).float()
    codes = quant.quantize_weight_w8(randn(3072, 2048).float())
    fused = quant.w8a8_matvec(x, **codes)
    # a 32-row prefill's masked attention (causal over a 42-slot cache)
    qp, kp, vp = randn(4, 32, 32, 64), randn(4, 8, 42, 64), randn(4, 8, 42,
                                                                  64)
    causal = attention.causal_mask_bias(32, 42, device=dev)[None, None]
    whole_p = attention.sdpa(qp, kp, vp, 0.125, mask_bias=causal)
    # a backbone step's row-wise reductions: the input's 33-slot sum and
    # the RMS norm
    slots, norm = randn(4, 1, 33, 2048), {"weight": randn(2048)}
    sums = slots.sum(dim=-2)
    normed = rms_norm(norm, x[:, None], 1e-5)
    return dict(
        prefill_heads=torch.equal(attention.sdpa(
            qp[:, :16], kp[:, :4], vp[:, :4], 0.125, mask_bias=causal),
            whole_p[:, :16]),
        prefill_rows=torch.equal(attention.sdpa(
            qp[:2], kp[:2], vp[:2], 0.125, mask_bias=causal), whole_p[:2]),
        slot_sum_rows=torch.equal(slots[:2].sum(dim=-2), sums[:2]),
        rms_norm_rows=torch.equal(rms_norm(norm, x[:2, None], 1e-5),
                                  normed[:2]),
        heads=torch.equal(attention.sdpa(q[:, :16], k[:, :4], v[:, :4],
                                         0.125), whole[:, :16]),
        rows=torch.equal(attention.sdpa(q[:2], k[:2], v[:2], 0.125),
                         whole[:2]),
        decoder_heads=torch.equal(attention.sdpa(
            qd[:, :4], kd[:, :1], vd[:, :1], 128 ** -0.5), whole_d[:, :4]),
        decoder_rows=torch.equal(attention.sdpa(
            qd[:2], kd[:2], vd[:2], 128 ** -0.5), whole_d[:2]),
        matmul_rows=torch.equal(torch.matmul(x[:2], w.t()),
                                torch.matmul(x, w.t())[:2]),
        fp32_head_rows=torch.equal(torch.matmul(h[:2], head),
                                   torch.matmul(h, head)[:2]),
        kernel1_rows=torch.equal(quant.w8a8_matvec(x[:2], **codes),
                                 fused[:2]))


def forced_logits(model: CSM, prompts, frames, n: int) -> tuple:
    """Teacher-forced logits of n frames for prompts of one bucket, under
    the model's tensor parallelism where it has one: each frame's backbone
    step is fed `frames` (per row an (F, 32) array; a row past its end
    repeats its last frame), and its decoder (dispatched) the frame's own
    codes. Returns (c0 (n, B, V), decoder (n, 31, B, V)) fp32 and the
    forced codes (n, B, 32)."""
    from csm_mlx_tpu_torch.models.csm import codebook0_logits
    from csm_mlx_tpu_torch.ops import tensor_parallel

    args, params, dev = model.args, model.params, model.device
    bcfg = args.backbone_config
    padded = [generation._pad_prompt(p, m) for p, m in prompts]
    if len({x[3] for x in padded}) != 1:
        raise ValueError("forced_logits takes prompts of one bucket")
    tokens, masks, pad = (
        torch.from_numpy(np.concatenate([x[i] for x in padded])).long().to(dev)
        for i in range(3))
    cap = padded[0][3] + n
    cos_b, sin_b = rope_cache_for(bcfg, max(cap, bcfg.max_position_embeddings),
                                  dev)
    cos_d, sin_d = rope_cache_for(args.decoder_config,
                                  args.n_audio_codebooks + 1, dev)
    want = torch.from_numpy(np.stack([
        np.stack([f[min(i, len(f) - 1)] for f in frames])
        for i in range(n)])).long().to(dev)
    greedy = SamplerConfig(temperature=0.0)
    c0s, decs = [], []
    with torch.no_grad(), tensor_parallel.scope(tensor_parallel.of(model)):
        cache = KVCache.init(bcfg, len(prompts), cap, dtype=model.dtype,
                             device=dev)
        h, _ = generation._prefill(params, args, tokens, masks, pad, cache,
                                   cos_b, sin_b)
        for i in range(n):
            if i:
                tk, mk = generation._frame_to_next_input(want[i - 1])
                h, _ = generation._backbone_step(params, args, tk, mk, pad,
                                                 cache, cos_b, sin_b)
            c0s.append(codebook0_logits(params, args, h).float())
            x01 = torch.stack([h, embed_audio(params, args, 0, want[i][:, 0])
                               .to(h.dtype)], dim=1)
            proj01 = linear(params["projection"], x01)
            _, dec = generation.dispatched_decode(
                params, args, proj01, greedy, None, cos_d, sin_d,
                forced=want[i])
            decs.append(dec)
    return torch.stack(c0s), torch.stack(decs), want


def layout_spreads(ref: tuple, got: tuple) -> dict:
    """The noise between two layouts of the same forced computation: per
    kind (c0, decoder), the std of got - ref over every logit, and that
    spread over the std of ref's logits."""
    out = {}
    for kind, r, g in (("c0", ref[0], got[0]), ("decoder", ref[1], got[1])):
        spread = (g - r).std().item()
        out[kind] = (spread, spread / r.std().item())
    return out


def first_differences(gots, wants, ref: tuple, spreads: dict) -> list:
    """Each row whose frames differ from the reference's: its first
    differing (frame, codebook), the reference's forced logit of its own
    pick less that of the row's pick there, and that margin's size in
    spreads of its kind (`layout_spreads`). A first difference within 4
    spreads (or one ulp) is a near tie of the layout's noise."""
    out = []
    for r, (got, want) in enumerate(zip(gots, wants)):
        common = min(len(got), len(want))
        diff = np.argwhere(got[:common] != want[:common])
        if not len(diff):
            if len(got) != len(want):
                out.append((r, None, None, float("inf"), float("inf")))
            continue
        f, c = (int(v) for v in diff[0])
        kind = "c0" if c == 0 else "decoder"
        logits = ref[0][f, r] if c == 0 else ref[1][f, c - 1, r]
        # the reference's own forced layout may prefer the row's pick
        # (a negative margin): its size counts the same
        margin = (logits[int(want[f, c])] - logits[int(got[f, c])]).item()
        ulp = torch.finfo(torch.float32).eps * abs(logits.max().item())
        out.append((r, f, c, margin, 0.0 if abs(margin) <= ulp else
                    abs(margin) / max(spreads[kind][0], 1e-12)))
    return out


def mesh_serving_rank(rank: int, n: int, store: str, payload: dict,
                      results) -> None:
    """One of (b)'s ranks: cuda:0, a gloo group, the kernels the parent
    built. {model: 2}: CSM-1B bf16 and W8A8 (dispatched), a one-process
    `generate_tokens_batch` of MESH_GLOO_ROWS prompts as the reference,
    then the same batch sharded and eager; bf16 also codebook 0's logits
    after the prefill both ways; W8A8 also kernel 1's int32 partials of
    this rank's columns of o_proj and down_proj, summed over the ranks,
    against the solo int32 sums. {data: 2}: the W8A8 engine at 4 slots
    with 4 requests, against a one-process engine. Reports to `results`;
    a failure reports its traceback."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        dev = torch.device(payload["device"])
        torch.cuda.set_device(dev)
        _build.build()
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, n), rank=rank, world_size=n,
            timeout=timedelta(minutes=10))
        args = csm_1b()
        out = dict(rank=rank)
        prompts = [synthetic_prompt(32, args.n_text_vocab, SEED + 200 + i)
                   for i in range(MESH_GLOO_ROWS)]
        ps, ms = [p for p, _ in prompts], [m for _, m in prompts]
        mesh_m = parallel.create_mesh({"model": n})
        for kind in ("bf16", "w8a8"):
            model = random_csm(args, torch.bfloat16, dev, SEED)
            if kind == "w8a8":
                quant.quantize_model(model, mode="w8a8")
            model = mesh_copy(model)  # the dispatched decoder, as a mesh
            want, want_n = generate_tokens_batch(
                model, ps, ms, MESH_GLOO_FRAMES, temperature=0.0)
            wants = [want[:want_n[r], r] for r in range(len(ps))]
            ref_c0 = mesh_c0_logits(model, ps[0], ms[0])
            ref = forced_logits(model, prompts, wants, MESH_GLOO_FRAMES)
            if kind == "w8a8":
                out["partials"] = mesh_partials(model, mesh_m, dev)
            sharded = parallel.shard_model(mesh_copy(model), mesh_m)
            del model
            torch.cuda.empty_cache()
            got_c0 = mesh_c0_logits(sharded, ps[0], ms[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, got_n = generate_tokens_batch(
                sharded, ps, ms, MESH_GLOO_FRAMES, temperature=0.0,
                mesh=mesh_m, _eager_step=True)
            wall = time.perf_counter() - t0
            # the sharded run's forced logits up to the last first
            # difference (the same on both ranks: their frames are equal)
            gots = [got[:got_n[r], r] for r in range(len(ps))]
            n_f = 1 + max([int(np.argwhere(g[:len(w)] != w[:len(g)])[0][0])
                           for g, w in zip(gots, wants)
                           if not np.array_equal(g, w)
                           and len(np.argwhere(g[:len(w)] != w[:len(g)]))]
                          + [0])
            spreads = layout_spreads(
                (ref[0][:n_f], ref[1][:n_f]),
                forced_logits(sharded, prompts, wants, n_f)[:2])
            out[kind] = dict(
                equal=bool(np.array_equal(got, want)
                           and np.array_equal(got_n, want_n)),
                agree=float((got == want).mean()), spreads=spreads,
                forced_frames=n_f,
                firsts=first_differences(gots, wants, ref, spreads),
                c0_err=(got_c0 - ref_c0).abs().max().item()
                / ref_c0.abs().max().item(),
                ms_frame=1e3 * wall / MESH_GLOO_FRAMES,
                local_rows=int(sharded.params["backbone"]["layers"][0][
                    "mlp"]["down_proj"]["weight_q" if kind == "w8a8"
                                         else "weight"].shape[1]))
            del sharded
            torch.cuda.empty_cache()
        mesh_d = parallel.create_mesh({"data": n})
        model = random_csm(args, torch.bfloat16, dev, SEED)
        quant.quantize_model(model, mode="w8a8")
        model = mesh_copy(model)
        reqs = [(p, m, mf) for (p, m), mf in zip(prompts,
                                                  MESH_GLOO_REQ_FRAMES)]
        want = mesh_engine_streams(model, None, reqs, n_slots=4)[0]
        sharded = parallel.shard_model(mesh_copy(model), mesh_d)
        got, ms_block, _ = mesh_engine_streams(sharded, mesh_d, reqs,
                                               n_slots=4, eager=True)
        if got is not None:
            # the layout's noise: the slots of a rank (2) against the
            # one-process engine's 4, teacher-forced on its streams
            n_f = max(len(w) for w in want)
            ref = forced_logits(model, prompts, want, n_f)
            halves = [forced_logits(model, prompts[lo:lo + 2],
                                    want[lo:lo + 2], n_f) for lo in (0, 2)]
            spreads = layout_spreads(ref[:2], (
                torch.cat([h[0] for h in halves], dim=1),
                torch.cat([h[1] for h in halves], dim=2)))
            out["engine"] = dict(
                equal=all(np.array_equal(a, b) for a, b in zip(got, want)),
                spreads=spreads,
                firsts=first_differences(got, want, ref, spreads),
                ms_block=ms_block)
        dist.destroy_process_group()
        results.put(out)
    except BaseException:  # the parent fails the phase with it
        results.put(dict(rank=rank, error=traceback.format_exc()))


def mesh_partials(model: CSM, mesh, dev) -> dict:
    """This rank's int32 partials of its columns of the backbone's layer-0
    o_proj and down_proj codes (`w8a8_partial`), summed over the model
    axis, against the whole codes' int32 sums through the kernel and its
    plain version: {name: bit-equal}."""
    from csm_mlx_tpu_torch.ops import tensor_parallel

    tp = tensor_parallel.TensorParallel(mesh.get_group("model"),
                                        mesh.size(),
                                        mesh.get_local_rank("model"))
    layer = model.params["backbone"]["layers"][0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 210)
    out = {}
    for name, wq in (("o_proj", layer["self_attn"]["o_proj"]["weight_q"]),
                     ("down_proj", layer["mlp"]["down_proj"]["weight_q"])):
        x = torch.randn((MESH_GLOO_ROWS, wq.shape[1]), generator=gen,
                        device=dev).to(torch.bfloat16)
        qx, _ = quant.w8a8_quant_rows(x)
        step = wq.shape[1] // tp.size
        lo = tp.rank * step
        local = quant.w8a8_partial(qx, lo, wq[:, lo:lo + step].contiguous())
        summed = tensor_parallel.all_reduce(local, tp)
        whole = quant.w8a8_partial(qx, 0, wq)
        plain = quant._int_dot(qx, wq).to(torch.int32)
        out[name] = bool(torch.equal(summed, whole)
                         and torch.equal(whole, plain))
    return out


def run_mesh_serving(dev, workdir: str) -> dict:
    """Sharded serving at full CSM-1B width: `shard_model` + `mesh=`.

    (a) One NCCL rank in this process, a {data: 1, model: 1} mesh, CSM-1B
    W8A8 (kernel 3's tables dropped: the dispatched decoder). Under a mesh
    the tensor-parallel code runs at a model axis of 1: o_proj and
    down_proj through kernel 1's three in-sharded entries, the embeddings
    and heads through their collectives, so the captured graphs hold NCCL
    calls. `generate_tokens` of MESH_FRAMES frames from a 32-row and a
    300-row prompt (kernel 2), captured, held to the mesh-less dispatched
    run of the same weights: exact equality (every collective is over one
    rank and the in-sharded entries give the fused kernel's bits). The
    engine (MESH_SLOTS slots, K = MESH_K, `flash_decode_min_b=8`, 16
    requests), captured, its streams held to the mesh-less engine's. The
    collectives each graph's capture recorded, and the device kernels and
    memcpy nodes of two frame-step replays (profiler). Kernel 1's
    in-sharded entries against their plain versions, timed beside the
    fused kernel (`check_tp_in`).
    (b) Two gloo ranks spawned on the one card (NCCL refuses two ranks on
    one GPU; gloo moves CUDA tensors through the host, so a graph cannot
    hold it: eager), `mesh_serving_rank`: {model: 2} bf16 and W8A8
    batches against a one-process run, the partials' check; {data: 2} the
    engine at 4 slots. A rank's heads or rows are another layout than the
    one-process run's, and the card's sums for a row or a head can change
    with the layout (`layout_probe`): each run is held to the one-process
    run by its first differences, every one a near tie (under 4 spreads
    of the layout's noise, measured teacher-forced: `forced_logits`,
    `layout_spreads`, `first_differences`), and that noise below
    FORCED_SPREAD_TOL of the logits' std. Its ms are gloo-bound readings,
    not speeds."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    args = csm_1b()
    info = card_info()
    t_phase = time.perf_counter()
    out = dict(kernels=check_tp_in(dev, torch.Generator(
        device=dev).manual_seed(SEED + 100)))
    t_a = time.perf_counter()
    counts = counting_collectives()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    mesh = parallel.create_mesh({"data": 1, "model": 1})
    model = build_csm_1b(dev)
    ref = mesh_copy(model)
    sharded = parallel.shard_model(mesh_copy(model), mesh)
    del model
    torch.cuda.empty_cache()
    runs = {}
    reset_counts()
    for rows, seed in ((32, SEED), (MESH_LONG_ROWS, SEED + 1)):
        prompt, mask = synthetic_prompt(rows, args.n_text_vocab, seed)
        want = generate_tokens(ref, prompt, mask, MESH_FRAMES,
                               temperature=0.0)
        before = read_counts()
        got = generate_tokens(sharded, prompt, mask, MESH_FRAMES,
                              temperature=0.0, mesh=mesh)
        after = read_counts()
        runs[rows] = dict(equal=bool(np.array_equal(got[0], want[0])
                                     and got[1] == want[1]), n=got[1],
                          counts={k: after[k] - before[k] for k in after})
    counts_gen = {k: sum(r["counts"][k] for r in runs.values())
                  for k in runs[32]["counts"]}
    graph = frame_step_graph(sharded, ref, counts)
    reqs = [synthetic_prompt(32, args.n_text_vocab, SEED + 300 + i)
            + (MESH_REQ_FRAMES[i % len(MESH_REQ_FRAMES)],)
            for i in range(MESH_SLOTS)]
    want, ms_ref, replay_ref = mesh_engine_streams(
        ref, None, reqs, n_slots=MESH_SLOTS, flash_decode_min_b=8)
    before = read_counts()
    engine_held = dict(counts)
    got, ms_mesh, replay_mesh = mesh_engine_streams(
        sharded, mesh, reqs, n_slots=MESH_SLOTS, flash_decode_min_b=8)
    after = read_counts()
    engine_held = {k: counts[k] - engine_held[k] for k in counts}
    engine_counts = {k: after[k] - before[k] for k in after}
    engine_equal = all(np.array_equal(a, b) for a, b in zip(got, want))
    dist.destroy_process_group()
    del ref, sharded
    torch.cuda.empty_cache()
    for rows, r in runs.items():
        c = r["counts"]
        log(f"mesh (a) one NCCL rank, {{data: 1, model: 1}}, CSM-1B W8A8 "
            f"dispatched, {rows}-row prompt, {r['n']} frames captured "
            f"({info}): equal to the mesh-less run {r['equal']}; launches "
            f"kernel 1 fused {c['w8a8_matvec']}, quant_rows "
            f"{c['w8a8_quant_rows']}, partial {c['w8a8_partial']}, fixup "
            f"{c['w8a8_fixup']}; kernel 2 {c['flash_prefill_sdpa']}; "
            f"kernel 3 {c['resident_decode_frame']}")
    log(f"mesh (a) the frame step's graph: its capture recorded "
        f"{graph['captured']['all_reduce']} all_reduce and "
        f"{graph['captured']['all_gather_into_tensor']} "
        f"all_gather_into_tensor NCCL calls; a replay under the profiler: "
        f"{graph['events']:.0f} device events, {graph['nccl']:.0f} NCCL "
        f"kernels, {graph['memcpy']:.0f} memcpy nodes (a one-rank NCCL "
        f"collective is a copy or nothing), kernel 1's quant_rows "
        f"{graph['quant_rows']:.0f}, partial {graph['partial']:.0f}, fixup "
        f"{graph['fixup']:.0f}; ms a replayed frame (5 replays, alternated) "
        + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                    for k, v in graph["ms"].items()))
    log(f"mesh (a) engine, {MESH_SLOTS} slots, K={MESH_K}, "
        f"flash_decode_min_b=8, {len(reqs)} requests: streams equal to the "
        f"mesh-less engine's {engine_equal}; device ms a replayed block "
        f"{replay_mesh:.2f} mesh, {replay_ref:.2f} mesh-less (wall ms a "
        f"block over the run, warm-ups and captures included, "
        f"{ms_mesh:.1f} and {ms_ref:.1f}); its captures "
        f"recorded {engine_held['all_reduce']} all_reduce and "
        f"{engine_held['all_gather_into_tensor']} all_gather_into_tensor "
        f"NCCL calls; launches kernel 1 fused "
        f"{engine_counts['w8a8_matvec']}, quant_rows "
        f"{engine_counts['w8a8_quant_rows']}, partial "
        f"{engine_counts['w8a8_partial']}, fixup "
        f"{engine_counts['w8a8_fixup']}, kernel 4 "
        f"{engine_counts['flash_decode_sdpa']}, kernel 2 "
        f"{engine_counts['flash_prefill_sdpa']}")
    probe = layout_probe(dev)
    log(f"layout probe ({info}): bit-equal to the same heads / rows of the "
        f"whole call: backbone attention on 16 of 32 heads "
        f"{probe['heads']}, on 2 of 4 rows {probe['rows']}; decoder "
        f"attention on 4 of 8 heads {probe['decoder_heads']}, on 2 of 4 rows "
        f"{probe['decoder_rows']}; a bf16 2,048 -> 2,051 matmul on 2 of 4 "
        f"rows {probe['matmul_rows']}; the fp32 audio head (1,024 -> 2,051) "
        f"on 2 of 4 rows {probe['fp32_head_rows']}; kernel 1 (2,048 -> "
        f"3,072) on 2 of 4 rows {probe['kernel1_rows']}; the 33-slot input "
        f"sum on 2 of 4 rows {probe['slot_sum_rows']}; the RMS norm on 2 of "
        f"4 rows {probe['rms_norm_rows']}; a 32-row prefill's causal "
        f"attention on 16 of 32 heads {probe['prefill_heads']}, on 2 of 4 "
        f"rows {probe['prefill_rows']}")
    if not all(r["equal"] for r in runs.values()) or not engine_equal:
        raise AssertionError("a one-rank mesh run differs from the "
                             "mesh-less run")
    if not (runs[MESH_LONG_ROWS]["counts"]["flash_prefill_sdpa"]
            and engine_counts["flash_decode_sdpa"]
            and all(counts_gen[f"w8a8_{e}"] for e in
                    ("matvec", "quant_rows", "partial", "fixup"))
            and graph["captured"]["all_reduce"]
            and engine_held["all_reduce"]):
        raise AssertionError("the mesh path skipped a kernel or a graph "
                             "holds no collective")

    t_b = time.perf_counter()
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    payload = dict(device=str(dev))
    procs = [ctx.Process(target=mesh_serving_rank,
                         args=(r, 2, f"{workdir}/mesh-store", payload,
                               results)) for r in range(2)]
    for p in procs:
        p.start()
    ranks = {}
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while len(ranks) < 2 and time.monotonic() < deadline:
            try:
                r = results.get(timeout=5)
            except __import__("queue").Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            ranks[r["rank"]] = r
            if "error" in r:
                break
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    log(f"mesh serving's parts: check_tp_in {t_a - t_phase:.1f} s, (a) "
        f"{t_b - t_a:.1f} s, (b) {time.perf_counter() - t_b:.1f} s")
    bad = [r["error"] for r in ranks.values() if "error" in r]
    if bad or len(ranks) < 2:
        raise AssertionError("mesh (b) failed: "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(bad))
    def held(m) -> bool:
        """Every first difference a near tie of a layout noise that is
        small against the logits."""
        return (all(x[4] < 4 for x in m["firsts"])
                and all(rel <= FORCED_SPREAD_TOL
                        for _, rel in m["spreads"].values()))

    def fmt(m) -> str:
        return ("; layout noise teacher-forced (spread, of the logits' std) "
                + ", ".join(f"{k} {sp:.3g} ({rel:.2%})"
                            for k, (sp, rel) in m["spreads"].items())
                + "; first differences (row, frame, codebook, margin, "
                "spreads) " + (", ".join(
                    f"({r}, {f}, {c}, {mg:.3g}, {sp:.2f})"
                    for r, f, c, mg, sp in m["firsts"]) or "none"))

    for r in (ranks[0], ranks[1]):
        for kind in ("bf16", "w8a8"):
            m = r[kind]
            log(f"mesh (b) rank {r['rank']}, {{model: 2}} over gloo on "
                f"cuda:0, CSM-1B {kind} dispatched, {MESH_GLOO_ROWS} rows x "
                f"{MESH_GLOO_FRAMES} frames, eager: frames equal to the "
                f"one-process run {m['equal']} ({m['agree']:.1%} of codes "
                f"agree)" + fmt(m) + f"; codebook 0's logits after the "
                f"prefill within {m['c0_err']:.2e} of their largest (tol "
                f"{STEP_TOL[torch.bfloat16]:g}); down_proj holds "
                f"{m['local_rows']} of 8192 input columns; "
                f"{m['ms_frame']:.0f} ms a frame (a gloo-bound reading: "
                f"each collective crosses the host)")
        log(f"mesh (b) rank {r['rank']}: kernel 1's int32 partials of its "
            f"columns, summed over the 2 ranks, equal the solo int32 sums "
            f"{r['partials']}")
    e = ranks[0]["engine"]
    log(f"mesh (b) {{data: 2}} engine, 4 slots (2 a rank), 4 requests, "
        f"W8A8 dispatched, eager: rank 0's streams equal the one-process "
        f"engine's {e['equal']}" + fmt(e) + f"; {e['ms_block']:.0f} ms a "
        f"block (a gloo-bound reading)")
    ok = (all(held(r["w8a8"]) and held(r["bf16"])
              and all(r["partials"].values())
              and r["bf16"]["c0_err"] <= STEP_TOL[torch.bfloat16]
              for r in ranks.values()) and held(e))
    if not ok:
        raise AssertionError("mesh (b): a sharded run leaves the "
                             "one-process run at more than a near tie")
    out.update(launches=counts_gen, graph=graph, engine=engine_counts,
               gloo=ranks)
    return out


def timed(fn, *a):
    """fn(*a), its seconds logged after the phase's own lines."""
    t0 = time.perf_counter()
    out = fn(*a)
    log(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # Mimi's fp32 convs would otherwise run in TF32 through cuDNN.
    torch.backends.cudnn.allow_tf32 = False
    log(card_info())  # name, power limit: as nvidia-smi prints them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    log(f"built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # the kernel cases added with the redesign of kernels 2 and 4
    gen_new = torch.Generator(device=dev)
    gen_new.manual_seed(SEED + 60)
    w8a8 = timed(check_w8a8, dev, gen)
    flash = timed(check_flash, dev, gen, gen_new)
    # the phases added with kernels 4 and 5 draw from their own generator,
    # so the earlier phases keep their inputs
    gen45 = torch.Generator(device=dev)
    gen45.manual_seed(SEED + 40)
    affine = timed(check_affine, dev, gen45, affine_generator(dev))
    decode = timed(check_flash_decode, dev, gen45, gen_new)
    mimi = Mimi(mimi_202407(32), dtype=torch.float32,
                generator=torch.Generator(device=dev).manual_seed(SEED + 2),
                device=dev)
    timed(check_small_vs_cpu, dev, mimi)
    timed(check_mimi_encode, dev, mimi)
    timed(check_small_affine_vs_cpu, dev)
    model = build_csm_1b(dev)
    frame = timed(check_resident, model, gen, gen_new)
    timed(check_resident_temperature, model, gen)
    main_path = timed(run_main_path, model, mimi)
    timed(trace_main_path, model)
    timed(run_streaming, model, mimi, main_path["frames_125"])
    timed(check_sampled_step, model)
    context = timed(run_context, model, mimi)
    disp = timed(run_dispatched, model)
    log(f"W8A8 launches per frame: {disp['w8a8_per_frame']:.0f} dispatched, "
        f"{main_path['counts']['w8a8_matvec'] / main_path['frames']:.0f} "
        f"with kernel 3; ms per frame captured (eager): "
        f"{disp['ms_per_frame']:.2f} ({disp['ms_eager']:.2f}) dispatched, "
        f"{main_path['ms_per_frame']:.2f} ({main_path['ms_eager']:.2f}) with "
        f"kernel 3")
    timed(time_prefill, model)
    timed(check_divergence, model, gen)
    timed(run_batch, model)
    batch = timed(run_batch_flash_decode, model, gen45)
    timed(frame_step_memory, model)
    serving = timed(run_serving, model, mimi)
    serving_ab = timed(run_serving_ab, model, mimi, serving["spreads"])
    timed(run_http, model, mimi)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        voice = timed(run_voice_chat, model, mimi, workdir)
        timed(run_trace, model, workdir)
    codec = timed(run_int8_codec, model, mimi, main_path["frames_125"])
    head = timed(run_int8_head, model, disp)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        timed(run_cli, dev, mimi, workdir)
    w4a8 = timed(run_w4a8, dev, w8a8, frame, main_path)
    affine_path = timed(run_affine_path, dev, mimi)

    flash_tr = timed(check_flash_train, dev, gen)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        training = timed(run_training, dev, workdir)
    timed(check_training_vs_plain, dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        par = timed(run_parallel, dev, workdir)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        mesh_serving = timed(run_mesh_serving, dev, workdir)

    launches = main_path["counts"]
    k3 = frame[1]  # the main path's shape: one row
    kernels = [
        dict(name="w8a8_matvec", route="cuda",
             source="csm_mlx_tpu_torch/csrc/w8a8_matvec.cu",
             replaces="csm_mlx_tpu/ops/quant.py:152",
             launches=launches["w8a8_matvec"],
             context_launches=context["counts"]["w8a8_matvec"],
             serving_launches=serving["counts"]["w8a8_matvec"],
             w4a8_launches=w4a8["counts"]["w8a8_matvec"],
             int8_head_launches=head["counts"]["w8a8_matvec"],
             int8_head_launches_a_frame=head["head_launches"],
             voice_chat_launches=voice["counts"]["w8a8_matvec"],
             int8_codec_engine_launches=codec["counts"]["w8a8_matvec"],
             w4a8=w4a8["kernel1"], w4a8_64_rows=w4a8["kernel1_64"],
             int8_head=head["kernel1"], int8_head_64_rows=head["kernel1_64"],
             **w8a8),
        dict(name="flash_prefill_sdpa", route="cuda",
             source="csm_mlx_tpu_torch/csrc/flash_prefill.cu",
             replaces="csm_mlx_tpu/ops/attention.py:34",
             launches=launches["flash_prefill_sdpa"],
             context_launches=context["counts"]["flash_prefill_sdpa"],
             voice_chat_launches=voice["counts"]["flash_prefill_sdpa"],
             serving_launches=serving["counts"]["flash_prefill_sdpa"],
             **flash),
        dict(name="resident_decode_frame", route="cuda",
             source="csm_mlx_tpu_torch/csrc/resident_frame.cu",
             replaces="csm_mlx_tpu/ops/resident_decoder.py:198",
             launches=launches["resident_decode_frame"],
             context_launches=context["counts"]["resident_decode_frame"],
             serving_launches=serving["counts"]["resident_decode_frame"],
             voice_chat_launches=voice["counts"]["resident_decode_frame"],
             w4a8_launches=w4a8["counts"]["resident_decode_frame"],
             w4a8=w4a8["kernel3"],
             max_abs_err=k3["max_abs_err"], agreement=k3["agreement"],
             ms=k3["ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None),
        dict(name="affine_matvec", route="cuda",
             source="csm_mlx_tpu_torch/csrc/affine_matvec.cu",
             replaces="csm_mlx_tpu/ops/quant.py:102",
             launches=affine_path["counts"]["affine_matvec"],
             voice_chat_launches=voice["affine_counts"]["affine_matvec"],
             **affine),
        dict(name="flash_decode_sdpa", route="cuda",
             source="csm_mlx_tpu_torch/csrc/flash_decode.cu",
             replaces="csm_mlx_tpu/ops/attention.py:166",
             launches=batch["counts"]["flash_decode_sdpa"],
             serving_launches=serving_ab["flash_counts"]["flash_decode_sdpa"],
             **decode),
        dict(name="flash_train_fwd", route="cuda",
             source="csm_mlx_tpu_torch/csrc/flash_train.cu",
             replaces="csm_mlx_tpu/ops/flash_train.py:88",
             launches=training["launches"][0],
             parallel_launches=par["launches"][0], **flash_tr["fwd"]),
        dict(name="flash_train_bwd", route="cuda",
             source="csm_mlx_tpu_torch/csrc/flash_train.cu",
             replaces="csm_mlx_tpu/ops/flash_train.py:126",
             launches=training["launches"][1],
             parallel_launches=par["launches"][1], **flash_tr["bwd"]),
    ]
    for entry in ("quant_rows", "partial", "fixup"):
        cases = mesh_serving["kernels"][entry]
        head = cases[TP_IN_ROWS.index(1) + len(TP_IN_ROWS)]  # down_proj, B=1
        kernels.insert(1 + ("quant_rows", "partial", "fixup").index(entry),
                       dict(name=f"w8a8_{entry}", of="w8a8_matvec",
                            route="cuda",
                            source="csm_mlx_tpu_torch/csrc/w8a8_matvec.cu",
                            replaces="csm_mlx_tpu/ops/quant.py:152",
                            launches=mesh_serving["launches"][f"w8a8_{entry}"],
                            engine_launches=mesh_serving["engine"][
                                f"w8a8_{entry}"],
                            case=head["case"],
                            max_abs_err=max(c["max_abs_err"] for c in cases),
                            ms=head["ms"], plain_ms=head["plain_ms"],
                            bound_ms=head["bound_ms"],
                            bound_by=head["bound_by"],
                            library_ms=head["library_ms"],
                            cases=cases))
    log(f"chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    log(card_info())  # again beside the results: the build log is long
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
