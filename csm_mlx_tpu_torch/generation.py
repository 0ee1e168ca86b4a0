"""Autoregressive text-to-speech generation (port of `csm_mlx_tpu/generation.py`).

The JAX package compiles the whole generation into one XLA program
(`lax.while_loop` over frames, `lax.scan` over the decoder steps) and
streaming into two (`_build_stream_fns_impl`). The port runs the prefill
and the first frame eagerly, then each later frame as one `FrameStep`: the
last frame fed back, a backbone step (`_backbone_step`), the next frame
(`_decode_frame`: c0 from `codebook0_head` through the sampler and the
processors, then the decoder primed with [backbone hidden, c0 embedding]
and 30 single-token steps scored against `audio_head[i-1]`) and, when
streaming, the Mimi decode step of the frame. On the card a step is
captured once as a CUDA graph and replayed every frame; on the CPU it runs
eagerly. EOS is the per-row all-zero frame, read on the host each frame.
With the whole-frame decoder's tables in the params (`quantize_model` on
CUDA prepares them), codebooks 1..31 of a frame come from one kernel-3
launch per chunk of <= 64 rows, as in the JAX package; without them (or
with a custom sampler) from the dispatched decoder, a loop of steps.

Prompts are left-padded to the same buckets as in the JAX package, so a
prompt gets the same positions and masks on both sides. Prefill runs the
flash-prefill kernel on CUDA for buckets of >= 256 rows (multiples of 128)
unless `CSM_TPU_FLASH_PREFILL=0`, the masked `sdpa` otherwise. A backbone
step runs the flash-decode kernel when the caller sets
`flash_decode_min_b` and the batch reaches it (off by default, as in JAX).

Entry points: `generate_frame` (one frame, its state threaded through
`FrameState`), `generate_tokens`, `generate_tokens_batch`, and the text
ones, which take conversational context (`Segment`s whose audio Mimi
encodes into prompt rows, `_assemble_prompt`): `generate`,
`generate_batch` (one row per text, each with its own context),
`stream_generate` and `generate_long` (sentence by sentence, with a
rolling context of what it generated). `watermark_key` embeds the keyed
watermark of `watermark.py` in the waveforms of `generate`,
`generate_batch` and `generate_long`, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from csm_mlx_tpu_torch.models.csm import (CSM, ModelArgs, embed_audio,
                                          masked_input_embeds)
from csm_mlx_tpu_torch.models.llama import llama_forward
from csm_mlx_tpu_torch.ops import launches, resident_decoder
from csm_mlx_tpu_torch.ops.attention import (NEG_INF, causal_mask_bias,
                                             key_validity_bias)
from csm_mlx_tpu_torch.ops.kv_cache import KVCache
from csm_mlx_tpu_torch.ops.layers import emb_table, linear
from csm_mlx_tpu_torch.ops.quant import audio_head_logits
from csm_mlx_tpu_torch.ops.rope import rope_cache_for
from csm_mlx_tpu_torch.ops.sampling import (HISTORY_SIZE, SamplerConfig,
                                            apply_processors)

PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
FRAME_MS = 80  # one RVQ frame = 80 ms of audio


def prompt_bucket(length: int) -> int:
    for b in PROMPT_BUCKETS:
        if length <= b:
            return b
    return length


def _prefill(params, args: ModelArgs, tokens, token_mask, pad_len,
             cache: KVCache, cos_b, sin_b):
    """Full-prompt backbone forward; returns (last_hidden (B, D), cache)."""
    bcfg = args.backbone_config
    b, p, _ = tokens.shape
    device = tokens.device
    embeds = masked_input_embeds(params, args, tokens, token_mask)
    pad_len = pad_len.reshape(-1)
    positions = torch.arange(p, device=device)[None, :] - pad_len[:, None]
    # As in the JAX package, CSM_TPU_FLASH_PREFILL=0 keeps long prompts on
    # the masked path too.
    if device.type == "cuda" and p >= 256 and p % 128 == 0 \
            and os.environ.get("CSM_TPU_FLASH_PREFILL", "1") == "1":
        hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                      sin_b, positions, None, cache,
                                      flash_pad_len=pad_len)
        return hidden[:, -1, :], cache
    # Keys span the whole cache: causal over the prompt, unwritten slots and
    # left-pad slots masked.
    cap = cache.capacity
    causal = causal_mask_bias(p, cap, device=device)
    key_valid = torch.arange(cap, device=device)[None, :] >= pad_len[:, None]
    mask_bias = torch.clamp(
        causal[None, None] + key_validity_bias(key_valid)[:, None], min=NEG_INF)
    hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                  sin_b, positions, mask_bias, cache)
    return hidden[:, -1, :], cache


def _backbone_step(params, args: ModelArgs, tokens, token_mask, pad_len,
                   cache: KVCache, cos_b, sin_b,
                   flash_decode_min_b: Optional[int] = None):
    """One-frame backbone decode step. tokens: (B, 1, 33). With
    `flash_decode_min_b` set and B >= it, attention runs kernel 4."""
    bcfg = args.backbone_config
    device = tokens.device
    pad_len = pad_len.reshape(-1, 1)
    embeds = masked_input_embeds(params, args, tokens, token_mask)
    positions = cache.index - pad_len  # (B, 1)
    k_idx = torch.arange(cache.capacity, device=device)[None]
    key_valid = (k_idx >= pad_len) & (k_idx <= cache.index)
    mask_bias = key_validity_bias(key_valid)[:, None]
    hidden, cache = llama_forward(params["backbone"], bcfg, embeds, cos_b,
                                  sin_b, positions, mask_bias, cache,
                                  decode_pad_len=pad_len.reshape(-1),
                                  flash_decode_min_b=flash_decode_min_b)
    return hidden[:, -1, :], cache


def _use_resident_decoder(params, sampler, b: int) -> int:
    """Kernel launches per frame for the whole-frame decoder: 0 when it
    cannot serve (no prepared tables, or a custom sampler), else the number
    of chunks of <= RESIDENT_MAX_BATCH rows the batch splits into."""
    if "_resident" not in params \
            or not resident_decoder.sampler_supported(sampler):
        return 0
    return -(-b // resident_decoder.RESIDENT_MAX_BATCH)


def _draw_seeds(generator, sampler, n_chunks: int, device) -> torch.Tensor:
    """Kernel 3's seeds of one frame, (n_chunks,) int32 on `device`, drawn
    from the caller's generator on the device (zeros when greedy): never
    read back, so a captured step draws anew at every replay."""
    if sampler.temperature > 0.0:
        return torch.randint(0, 2 ** 31 - 1, (n_chunks,), generator=generator,
                             device=device, dtype=torch.int32)
    return torch.zeros((n_chunks,), dtype=torch.int32, device=device)


def _decode_frame(params, args: ModelArgs, last_hidden, generator, history,
                  sampler, processors: Tuple, cos_d, sin_d, seeds=None):
    """Sample the 32 codebooks of one frame from the backbone hidden state:
    c0 through the sampler and processor chain, codebooks 1..31 through
    the decoder with plain temperature sampling — the whole-frame kernel
    when the params carry its tables (one call per chunk, seeded from
    `seeds`, drawn here when None), else the dispatched decoder.
    Returns (frame (B, 32), history)."""
    b = last_hidden.shape[0]
    device = last_hidden.device

    c0_logits = linear(params["codebook0_head"], last_hidden).float()
    c0_logits = apply_processors(processors, history, c0_logits)
    c0 = sampler(generator, c0_logits)
    history = torch.roll(history, -1, dims=-1)
    history[:, -1] = c0

    c0_emb = embed_audio(params, args, 0, c0).to(last_hidden.dtype)
    x01 = torch.stack([last_hidden, c0_emb], dim=1)  # (B, 2, D_backbone)
    proj01 = linear(params["projection"], x01)

    n_chunks = _use_resident_decoder(params, sampler, b)
    if n_chunks:
        # One kernel-3 launch per chunk (the plain version on the CPU);
        # c0, its processors and the projection stay outside, as in JAX.
        if seeds is None:
            seeds = _draw_seeds(generator, sampler, n_chunks, device)
        proj01_t = proj01.float().transpose(0, 1)  # (2, B, d_decoder)
        cs = -(-b // n_chunks)
        parts = [resident_decoder.resident_decode_frame(
            params["_resident"], args, proj01_t[:, lo:lo + cs],
            seeds[i:i + 1], sampler.temperature)
            for i, lo in enumerate(range(0, b, cs))]
        toks = torch.cat(parts, dim=1)  # (n_cb, B)
        frame = torch.cat([c0[:, None], toks[1:].t().long()], dim=1)
        return frame, history

    dec_sampler = (SamplerConfig(temperature=sampler.temperature)
                   if type(sampler) is SamplerConfig else sampler)
    codes, _ = dispatched_decode(params, args, proj01, dec_sampler,
                                 generator, cos_d, sin_d)
    return torch.cat([c0[:, None], codes], dim=1), history


def dispatched_decode(params, args: ModelArgs, proj01, dec_sampler,
                      generator, cos_d, sin_d, forced=None):
    """The dispatched decoder: a fresh 33-slot cache primed with proj01
    (B, 2, d_decoder), then one eager llama step per codebook, scored
    against `audio_head[i-1]`. Returns (codes (B, n_cb-1) of codebooks
    1..n_cb-1, logits (n_cb-1, B, V) f32). With `forced` (B, n_cb), step i
    reads the embedding of forced[:, i-1] instead of its own pick (teacher
    forcing); the returned codes stay its picks."""
    dcfg = args.decoder_config
    b, n_cb = proj01.shape[0], args.n_audio_codebooks
    device, dtype = proj01.device, proj01.dtype
    audio_head = params["audio_head"]
    cap = n_cb + 1
    dcache = KVCache.init(dcfg, b, cap, dtype=dtype, device=device)

    def dec_bias(q_len, index):
        return causal_mask_bias(q_len, cap, q_offset=index,
                                device=device)[None, None]

    hidden, dcache = llama_forward(
        params["decoder"], dcfg, proj01, cos_d, sin_d,
        torch.arange(2, device=device)[None], dec_bias(2, 0), dcache)
    logits = [audio_head_logits(audio_head, 0, hidden[:, -1])]
    codes = [dec_sampler(generator, logits[0])]
    table = emb_table(params["audio_embeddings"])
    for i in range(2, n_cb):
        prev = codes[-1] if forced is None else forced[:, i - 1]
        emb = table[prev + (i - 1) * args.n_audio_vocab].to(dtype)
        x = linear(params["projection"], emb[:, None, :])
        # step i writes slot i: a Python int, nothing read from the device
        positions = torch.full((1, 1), i, device=device)
        hidden, dcache = llama_forward(params["decoder"], dcfg, x, cos_d,
                                       sin_d, positions, dec_bias(1, i),
                                       dcache)
        logits.append(audio_head_logits(audio_head, i - 1, hidden[:, 0]))
        codes.append(dec_sampler(generator, logits[-1]))
    return torch.stack(codes, dim=1), torch.stack(logits).float()


def _frame_to_next_input(frame):
    """A sampled frame as the next (B, 1, 33) input and mask: audio slots
    = frame, text slot = 0 and unmasked."""
    zeros = torch.zeros_like(frame[:, :1])
    tokens = torch.cat([frame, zeros], dim=1)[:, None, :]
    mask = torch.cat([torch.ones_like(frame), zeros], dim=1)[:, None, :]
    return tokens, mask


def _pad_prompt(prompt: np.ndarray, mask: np.ndarray) -> tuple:
    """Left-pad to the bucket size; returns (tokens (1, P, 33), mask,
    pad_len (1,), bucket)."""
    s = prompt.shape[0]
    bucket = prompt_bucket(s)
    pad = bucket - s
    tokens = np.zeros((1, bucket, prompt.shape[1]), dtype=np.int32)
    m = np.zeros((1, bucket, prompt.shape[1]), dtype=np.int32)
    tokens[0, pad:] = prompt
    m[0, pad:] = mask
    return tokens, m, np.asarray([pad], dtype=np.int32), bucket


def _assemble_prompt(model: CSM, text: str, speaker: int, context: Sequence,
                     mimi=None) -> tuple:
    """The context segments' rows (text, then Mimi's codes of the audio),
    then the text's -> (prompt (S, K+1) int32, mask). `mimi` encodes the
    audio, by default the codec singleton on the model's device."""
    from csm_mlx_tpu_torch.tokenizers import (tokenize_segment,
                                              tokenize_text_segment)

    if context:
        mimi = _codec_for(model, mimi)
    tokens, masks = [], []
    for segment in context:
        t, m = tokenize_segment(segment,
                                n_audio_codebooks=model.n_audio_codebooks,
                                mimi=mimi)
        tokens.append(t)
        masks.append(m)
    t, m = tokenize_text_segment(text, speaker, model.n_audio_codebooks)
    tokens.append(np.asarray(t))
    masks.append(np.asarray(m))
    return (np.concatenate(tokens, axis=0).astype(np.int32),
            np.concatenate(masks, axis=0).astype(np.int32))


def _watermarked(audio: torch.Tensor, watermark_key) -> torch.Tensor:
    if watermark_key is None:
        return audio
    from csm_mlx_tpu_torch.watermark import embed_watermark

    return embed_watermark(audio, watermark_key)


def _codec_for(model: CSM, mimi):
    from csm_mlx_tpu_torch.tokenizers import get_audio_tokenizer

    return mimi if mimi is not None else get_audio_tokenizer(
        model.n_audio_codebooks, device=model.device)


def _check_context_window(args: ModelArgs, prompt_len: int,
                          max_frames: int) -> None:
    context_window = args.backbone_config.max_position_embeddings or 2048
    max_seq_len = context_window - max_frames
    if prompt_len >= max_seq_len:
        raise ValueError(
            f"Inputs too long ({prompt_len}), must be below max_seq_len - "
            f"max_audio_frames: {max_seq_len}")


def _resolve_sampler(temperature: float, sampler: Optional[Any]):
    return SamplerConfig(temperature=temperature) if sampler is None \
        else sampler


class FrameStep:
    """One frame of generation over static buffers: the port of the frame
    body of JAX's compiled loops (`_build_generate_tokens_impl`'s `body`,
    `_build_stream_fns_impl`'s `step`). A step feeds the last frame back
    (`_frame_to_next_input`), runs a backbone step, samples the next frame
    (`_decode_frame`) and, with a codec, runs the Mimi decode step of it.

    Its buffers are updated in place: `frame` (B, 32) int64 (the step's
    input, then its output), `history`, the backbone `cache` (its write
    index on the device), `seeds` (kernel 3's seeds of the frame), `pad`,
    and with a codec the decode `state` and `chunk` (B, frame_size).
    `prefill` and `first` start a stream (eagerly); each call then makes
    one frame.

    On CUDA tensors the step is a CUDA graph: the first call runs it
    eagerly on a side stream (a real frame, which also does every
    first-use set-up: the kernel library, cuBLAS, cuDNN's choice of
    algorithm), the second captures it on that stream, with the caller's
    generator registered so that every replay draws anew, and every call
    from then on replays it. A replay runs the captured kernels without
    calling their wrappers, so it adds the launches the capture recorded to
    the wrappers' counters (`captured`, by the counters' registry
    `ops.launches`); the capture itself launches nothing and counts
    nothing. The overflow check reads the host's count
    of the cache (`cache.length`), which a replay advances. `eager=True`
    (or CPU tensors) runs every call eagerly on the current stream.
    """

    def __init__(self, model: CSM, b: int, capacity: int, sampler,
                 processors: Tuple, generator: Optional[torch.Generator],
                 flash_decode_min_b: Optional[int] = None, codec=None,
                 eager: bool = False):
        args, device = model.args, model.device
        bcfg, dcfg = args.backbone_config, args.decoder_config
        self.params, self.args, self.device = model.params, args, device
        self.sampler, self.processors = sampler, processors
        self.generator, self.codec = generator, codec
        self.flash_decode_min_b = flash_decode_min_b
        self.capture = device.type == "cuda" and not eager
        if self.capture and generator is not None \
                and generator.device != device:
            raise ValueError(f"a captured frame step draws on {device}; the "
                             f"generator is on {generator.device}")
        self.cos_b, self.sin_b = rope_cache_for(
            bcfg, max(capacity, bcfg.max_position_embeddings), device)
        self.cos_d, self.sin_d = rope_cache_for(
            dcfg, args.n_audio_codebooks + 1, device)
        self.cache = KVCache.init(bcfg, b, capacity, dtype=model.dtype,
                                  device=device)
        self.pad = torch.zeros((b,), dtype=torch.long, device=device)
        self.frame = torch.zeros((b, args.n_audio_codebooks),
                                 dtype=torch.long, device=device)
        self.history = torch.full((b, HISTORY_SIZE), -1, dtype=torch.long,
                                  device=device)
        self.seeds = torch.zeros(
            (_use_resident_decoder(model.params, sampler, b),),
            dtype=torch.int32, device=device)
        if codec is not None:
            self.state = codec.init_decode_state(batch=b)
            self.chunk = torch.zeros((b, codec.frame_size),
                                     dtype=codec.dtype, device=device)
        self.graph = None
        self._warm = False
        self._stream = None
        self.captured: dict = {}
        self.replays = 0

    def prefill(self, tokens: np.ndarray, mask: np.ndarray,
                pad_len: np.ndarray) -> torch.Tensor:
        """Start a stream: the buffers reset and the left-padded prompt
        (B, bucket, 33) prefilled into the cache; returns the last hidden
        state (B, D)."""
        self.cache.k.zero_()
        self.cache.v.zero_()
        self.cache.index.zero_()
        self.cache.length = 0
        self.history.fill_(-1)
        self.pad.copy_(torch.from_numpy(pad_len).long())
        if self.codec is not None:
            for t in _tensors(self.state):
                t.zero_()
        t = torch.from_numpy(tokens).long().to(self.device)
        m = torch.from_numpy(mask).long().to(self.device)
        last_hidden, _ = _prefill(self.params, self.args, t, m, self.pad,
                                  self.cache, self.cos_b, self.sin_b)
        return last_hidden

    def first(self, last_hidden: torch.Tensor) -> None:
        """The stream's first frame from the prefill's hidden state
        (eager)."""
        self._decode(last_hidden)

    def _decode(self, last_hidden: torch.Tensor) -> None:
        if self.seeds.numel():
            self.seeds.copy_(_draw_seeds(self.generator, self.sampler,
                                         self.seeds.numel(), self.device))
        frame, history = _decode_frame(
            self.params, self.args, last_hidden, self.generator,
            self.history, self.sampler, self.processors, self.cos_d,
            self.sin_d, seeds=self.seeds if self.seeds.numel() else None)
        self.frame.copy_(frame)
        self.history.copy_(history)
        if self.codec is not None:
            from csm_mlx_tpu_torch.models.mimi.mimi import mimi_decode_step_fn

            audio, _ = mimi_decode_step_fn(self.codec.params, self.codec.cfg,
                                           frame[..., None], self.state)
            self.chunk.copy_(audio[:, 0])

    def _step(self) -> None:
        tokens, mask = _frame_to_next_input(self.frame)
        last_hidden, _ = _backbone_step(
            self.params, self.args, tokens, mask, self.pad, self.cache,
            self.cos_b, self.sin_b, self.flash_decode_min_b)
        self._decode(last_hidden)

    def __call__(self) -> None:
        """The next frame, into the buffers."""
        if self.cache.length + 1 > self.cache.capacity:
            raise ValueError(f"KV cache overflow: index {self.cache.length} "
                             f"+ 1 new token > capacity "
                             f"{self.cache.capacity}")
        if not self.capture:
            self._step()
            return
        if not self._warm:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._step()
            torch.cuda.current_stream().wait_stream(self._stream)
            self._warm = True
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        self.cache.length += 1
        for (fn, attr), n in self.captured.items():
            setattr(fn, attr, getattr(fn, attr) + n)

    def _capture(self) -> None:
        counters = list(launches.COUNTERS.values())
        before = [getattr(fn, attr) for fn, attr in counters]
        length = self.cache.length
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=self._stream):
            self._step()
        self.cache.length = length  # the capture ran nothing
        for (fn, attr), n in zip(counters, before):
            if getattr(fn, attr) != n:
                self.captured[(fn, attr)] = getattr(fn, attr) - n
                setattr(fn, attr, n)
        self.graph = graph


def _tensors(tree) -> list:
    """The tensor leaves of nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


# A model keeps at most this many captured frame steps (each holds its KV
# cache and its graph's memory), the least recently used dropped first.
_STEPS_PER_MODEL = 4
_STEPS_LOCK = threading.Lock()


@contextlib.contextmanager
def _held(steps: dict, key, build: Callable[[], Any]) -> Iterator[Any]:
    """The step of `key`, held by one caller at a time: taken out of
    `steps` for the length of the `with` (built anew by `build` when it is
    not there: never built, or held by another call), then put back as the
    most recently used, also when the caller is a generator that is closed
    or dropped. A step whose caller raised is dropped: its buffers may be
    half written, its graph half captured."""
    with _STEPS_LOCK:
        step = steps.pop(key, None)
    if step is None:
        step = build()
    done = False
    try:
        yield step
        done = True
    except GeneratorExit:
        done = True
        raise
    finally:
        if done:
            with _STEPS_LOCK:
                steps.pop(key, None)
                while len(steps) >= _STEPS_PER_MODEL:
                    steps.pop(next(iter(steps)))
                steps[key] = step


@contextlib.contextmanager
def _frame_step(model: CSM, b: int, capacity: int, sampler,
                processors: Tuple, generator, flash_decode_min_b=None,
                codec=None, eager: bool = False) -> Iterator[FrameStep]:
    """The frame step of a configuration, the caller's alone for the length
    of the `with`. On the card, the one captured before for the same (B,
    capacity, sampler, processors, generator, codec, parameter buffers) if
    no other call holds it, else a new one; it is kept on the model
    (`CSM.frame_steps`) for the next call. Eager or on the CPU, a new one,
    dropped after."""
    def build() -> FrameStep:
        return FrameStep(model, b, capacity, sampler, processors, generator,
                         flash_decode_min_b, codec, eager=eager)

    if eager or model.device.type != "cuda":
        yield build()
        return
    key = (b, capacity, sampler, processors, flash_decode_min_b,
           None if generator is None else id(generator),
           None if codec is None else id(codec),
           tuple(t.data_ptr() for t in _tensors(model.params)))
    with _held(model.frame_steps, key, build) as step:
        yield step


@torch.no_grad()
def _generate_padded(model: CSM, tokens: np.ndarray, mask: np.ndarray,
                     pad_len: np.ndarray, bucket: int, max_frames: int,
                     sampler, processors: Tuple,
                     generator: Optional[torch.Generator],
                     flash_decode_min_b: Optional[int] = None,
                     _eager_step: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The frame loop over a left-padded batch; returns (frames
    (max_frames, B, 32) int32, n_frames (B,) int32). A row stops counting
    frames at its first all-zero frame; the loop ends when every row has
    stopped or after max_frames. The prefill and the first frame run
    eagerly, every later frame through the `FrameStep` (a replayed CUDA
    graph on the card; `_eager_step` runs it eagerly, for comparing the
    two). Backbone steps of B >= `flash_decode_min_b` rows run their
    attention through kernel 4 (None: never)."""
    args = model.args
    device = model.device
    b = tokens.shape[0]
    frames = torch.zeros((max_frames, b, args.n_audio_codebooks),
                         dtype=torch.long, device=device)
    n_frames = torch.zeros((b,), dtype=torch.long, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    with _frame_step(model, b, bucket + max_frames, sampler, processors,
                     generator, flash_decode_min_b,
                     eager=_eager_step) as step:
        step.first(step.prefill(tokens, mask, pad_len))
        for i in range(max_frames):
            done = done | (step.frame == 0).all(dim=1)
            frames[i] = step.frame
            n_frames = torch.where(done, n_frames, i + 1)
            if bool(done.all()) or i + 1 == max_frames:
                break
            step()
    return (frames.to(torch.int32).cpu().numpy(),
            n_frames.to(torch.int32).cpu().numpy())


def generate_tokens(
    model: CSM,
    prompt: np.ndarray,
    prompt_mask: np.ndarray,
    max_audio_frames: int,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    flash_decode_min_b: Optional[int] = None,
    _eager_step: bool = False,
) -> Tuple[np.ndarray, int]:
    """One (S, 33) prompt -> (frames (F, 32) int32, F). `flash_decode_min_b`
    as in `generate_tokens_batch`: one row takes kernel 4 only at 1."""
    _check_context_window(model.args, prompt.shape[0], max_audio_frames)
    tokens, mask, pad_len, bucket = _pad_prompt(prompt, prompt_mask)
    frames, n = _generate_padded(
        model, tokens, mask, pad_len, bucket, max_audio_frames,
        _resolve_sampler(temperature, sampler),
        tuple(logits_processors or ()), generator, flash_decode_min_b,
        _eager_step)
    n = int(n[0])
    return frames[:n, 0, :], n


def generate_tokens_batch(
    model: CSM,
    prompts: Sequence[np.ndarray],
    prompt_masks: Sequence[np.ndarray],
    max_audio_frames: int,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    flash_decode_min_b: Optional[int] = None,
    _eager_step: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Prompts left-padded to a common bucket; each row stops at its own
    all-zero frame. Returns (frames (max_frames, B, 32), n_frames (B,)).

    `flash_decode_min_b`: at B >= it, each backbone step's attention runs
    the flash-decode kernel (`ops.attention.flash_decode_sdpa`, kernel 4)
    instead of the masked `sdpa`; None (the default) keeps it off, as the
    JAX package's `CSM_TPU_FLASH_DECODE` is off by default (which gates at
    `CSM_TPU_FLASH_DECODE_MIN_B`, 8). The decoder never takes it."""
    b = len(prompts)
    longest = max(p.shape[0] for p in prompts)
    _check_context_window(model.args, longest, max_audio_frames)
    bucket = prompt_bucket(longest)
    n_slots = prompts[0].shape[1]
    tokens = np.zeros((b, bucket, n_slots), dtype=np.int32)
    mask = np.zeros((b, bucket, n_slots), dtype=np.int32)
    pad_len = np.zeros((b,), dtype=np.int32)
    for i, (p, m) in enumerate(zip(prompts, prompt_masks)):
        pad = bucket - p.shape[0]
        tokens[i, pad:] = p
        mask[i, pad:] = m
        pad_len[i] = pad
    return _generate_padded(
        model, tokens, mask, pad_len, bucket, max_audio_frames,
        _resolve_sampler(temperature, sampler),
        tuple(logits_processors or ()), generator, flash_decode_min_b,
        _eager_step)


def generate(
    model: CSM,
    text: str,
    speaker: int,
    context: Sequence = (),
    max_audio_length_ms: float = 90_000,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    watermark_key: Optional[int] = None,
    mimi=None,
) -> torch.Tensor:
    """Text (+ conversational context) -> 24 kHz waveform (1-D tensor), in
    JAX's argument order, `generator` in place of `key`.

    The text goes through the canonical tokenizer
    (`tokenizers.get_text_tokenizer`: a local path installed earlier or
    `CSM_TPU_TEXT_TOKENIZER`); `mimi` is the codec that encodes the
    context's audio and decodes the frames, by default the
    `get_audio_tokenizer` singleton on the model's device."""
    codec = _codec_for(model, mimi)
    max_frames = int(max_audio_length_ms / FRAME_MS)
    prompt, mask = _assemble_prompt(model, text, speaker, context, codec)
    frames, n = generate_tokens(
        model, prompt, mask, max_frames, temperature=temperature,
        sampler=sampler, logits_processors=logits_processors,
        generator=generator)
    if n == 0:
        return torch.zeros((0,), dtype=torch.float32)
    codes = torch.from_numpy(frames.T[None].copy()).long()  # (1, K, F)
    return _watermarked(codec.decode(codes)[0, 0], watermark_key)


def generate_batch(
    model: CSM,
    texts: Sequence[str],
    speakers: Sequence[int],
    contexts: Optional[Sequence[Sequence]] = None,
    max_audio_length_ms: float = 90_000,
    watermark_key: Optional[int] = None,
    *,
    mimi=None,
    **kwargs,
) -> list:
    """Batched TTS: one waveform (1-D tensor) per (text, speaker[, context])
    row. The rows' prompts, each with its own context, are left-padded to
    one bucket (`generate_tokens_batch`, which takes `kwargs`); the frames
    of every row go through one Mimi decode over the longest row, sliced
    per row to its own frames (each then watermarked with
    `watermark_key`, if given)."""
    contexts = contexts or [()] * len(texts)
    if not (len(texts) == len(speakers) == len(contexts)):
        # zip would truncate, and the per-row slicing drop rows
        raise ValueError(
            f"texts/speakers/contexts lengths differ: {len(texts)}/"
            f"{len(speakers)}/{len(contexts)}")
    codec = _codec_for(model, mimi)
    max_frames = int(max_audio_length_ms / FRAME_MS)
    prompts, masks = zip(*[
        _assemble_prompt(model, text, speaker, context, codec)
        for text, speaker, context in zip(texts, speakers, contexts)])
    frames, n = generate_tokens_batch(model, prompts, masks, max_frames,
                                      **kwargs)
    f_max = int(n.max()) if len(n) else 0
    if f_max == 0:
        return [torch.zeros((0,), dtype=torch.float32) for _ in texts]
    codes = torch.from_numpy(
        np.ascontiguousarray(frames[:f_max].transpose(1, 2, 0))).long()
    audio = codec.decode(codes)
    frame_size = audio.shape[-1] // f_max
    return [_watermarked(audio[i, 0, :int(n[i]) * frame_size], watermark_key)
            for i in range(len(texts))]


def generate_long(
    model: CSM,
    text: str,
    speaker: int,
    context: Sequence = (),
    *,
    max_segment_audio_ms: float = 30_000,
    rolling_context: int = 6,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    generator: Optional[torch.Generator] = None,
    watermark_key: Optional[int] = None,
    pause_ms: float = 0.0,
    mimi=None,
) -> torch.Tensor:
    """Long-form synthesis past the model's context window, as in the JAX
    package: `text` split into sentences, each synthesized by `generate`
    with the last `rolling_context` generated segments as its context
    (the voice carries through it), the pieces joined (a 1-D CPU tensor),
    `pause_ms` of silence between them. The rolling context is trimmed by
    its prompt rows (text tokens + Mimi frames + EOS frame of each
    segment) against the backbone window less `max_segment_audio_ms`; a
    sentence too long alone is split at words (`fit_sentence`), a word too
    long at characters (`hard_split`). `generator` draws for every
    sentence in turn (JAX splits its `key`); `watermark_key` marks the
    joined waveform."""
    from csm_mlx_tpu_torch.apps.voice_chat import split_sentences
    from csm_mlx_tpu_torch.segment import SAMPLING_RATE, Segment
    from csm_mlx_tpu_torch.tokenizers import get_text_tokenizer

    sentences = split_sentences(text) or (
        [text.strip()] if text.strip() else [])
    ctx = list(context)
    pieces = []
    txt_tok = get_text_tokenizer()
    frame_size = int(SAMPLING_RATE * FRAME_MS / 1000)

    def n_text(spk: int, s: str) -> int:
        return len(txt_tok.encode(f"[{spk}]{s}").ids)

    def seg_len(seg: Segment) -> int:
        frames = -(-int(np.asarray(seg.audio).shape[-1]) // frame_size)
        return n_text(seg.speaker, seg.text) + frames + 1

    max_seg_frames = int(max_segment_audio_ms / FRAME_MS)
    ctx_cfg = model.args.backbone_config.max_position_embeddings or 2048
    budget = ctx_cfg - max_seg_frames
    if budget <= 1:
        # fit_sentence / hard_split would explode the text into single
        # characters before generate failed on a negative window
        raise ValueError(
            f"max_segment_audio_ms={max_segment_audio_ms} "
            f"({max_seg_frames} frames) does not fit the backbone context "
            f"window ({ctx_cfg} positions) with room for any text; use a "
            f"smaller segment budget")

    def hard_split(word: str) -> list:
        """The largest prefixes that fit, found by bisection; at least one
        character each, so that any budget terminates."""
        out, lo = [], 0
        while lo < len(word):
            best, lo_b, hi_b = lo + 1, lo + 1, len(word)
            while lo_b <= hi_b:
                mid = (lo_b + hi_b) // 2
                if n_text(speaker, word[lo:mid]) < budget:
                    best, lo_b = mid, mid + 1
                else:
                    hi_b = mid - 1
            out.append(word[lo:best])
            lo = best
        return out

    def fit_sentence(sentence: str) -> list:
        """A sentence over the budget alone, split into word chunks that
        fit (and a word over it by `hard_split`)."""
        if n_text(speaker, sentence) < budget:
            return [sentence]
        parts, cur = [], []

        def flush():
            if cur:
                parts.append(" ".join(cur))
                cur.clear()

        for w in sentence.split() or [sentence]:
            if n_text(speaker, w) >= budget:
                flush()
                parts.extend(hard_split(w))
                continue
            if cur and n_text(speaker, " ".join(cur + [w])) >= budget:
                flush()
            cur.append(w)
        flush()
        return parts

    sentences = [p for s in sentences for p in fit_sentence(s)]
    ctx_lens = [seg_len(s) for s in ctx]
    gap = (np.zeros((int(pause_ms * SAMPLING_RATE / 1000),), np.float32)
           if pause_ms > 0 else None)
    for sentence in sentences:
        sent_tokens = n_text(speaker, sentence)
        while ctx and sum(ctx_lens) + sent_tokens >= budget:
            ctx.pop(0)  # the oldest context segment first
            ctx_lens.pop(0)
        audio = generate(model, sentence, speaker, tuple(ctx),
                         max_audio_length_ms=max_segment_audio_ms,
                         temperature=temperature, sampler=sampler,
                         generator=generator, mimi=mimi)
        if audio.shape[0] == 0:
            continue
        host_audio = audio.float().cpu().numpy()
        if gap is not None and pieces:
            pieces.append(gap)  # between pieces only, never a silent tail
        pieces.append(host_audio)
        if rolling_context > 0:
            seg = Segment(speaker, sentence, host_audio)
            ctx.append(seg)
            ctx_lens.append(seg_len(seg))
            ctx = ctx[-rolling_context:]
            ctx_lens = ctx_lens[-rolling_context:]
        else:
            ctx, ctx_lens = [], []
    if not pieces:
        return torch.zeros((0,), dtype=torch.float32)
    # marked on the model's device, returned on the CPU
    return _watermarked(torch.from_numpy(np.concatenate(pieces)).to(
        model.device), watermark_key).cpu()


class FrameState(tuple):
    """(frame, cache, generator, history) returned by stateful
    `generate_frame`."""

    __slots__ = ()

    frame = property(lambda self: self[0])
    cache = property(lambda self: self[1])
    generator = property(lambda self: self[2])
    history = property(lambda self: self[3])


@torch.no_grad()
def generate_frame(
    model: CSM,
    tokens,
    *,
    temperature: float = 0.8,
    token_mask=None,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    cache: Optional[KVCache] = None,
    pad_len=None,
    generator: Optional[torch.Generator] = None,
    history: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """One 32-codebook frame from (B, S, 33) tokens: a prefill when S > 1,
    else a backbone step, then the frame (eagerly, one call a frame).

    As in the JAX package, a frame loop passes `return_state=True` and
    threads the returned `FrameState` (frame, cache, generator, history)
    into the next call; passing cache / generator / history without
    `return_state=True` raises. The port's cache is advanced in place, the
    generator draws in place. A new cache holds max(max_position_embeddings
    or 2048, S) positions."""
    if (cache is not None or generator is not None or history is not None) \
            and not return_state:
        raise ValueError(
            "generate_frame received cache/generator/history but "
            "return_state is False; the advanced state would be silently "
            "discarded. Pass return_state=True and thread the returned "
            "(frame, cache, generator, history) into the next call.")
    args, device = model.args, model.device
    bcfg = args.backbone_config
    smp = _resolve_sampler(temperature, sampler)
    tokens = torch.as_tensor(tokens, device=device).long()
    b, s = tokens.shape[0], tokens.shape[1]
    token_mask = torch.ones_like(tokens) if token_mask is None else \
        torch.as_tensor(token_mask, device=device).long()
    if history is None:
        history = torch.full((b, HISTORY_SIZE), -1, dtype=torch.long,
                             device=device)
    if cache is None:
        capacity = max(bcfg.max_position_embeddings or 2048, s)
        cache = KVCache.init(bcfg, b, capacity, dtype=model.dtype,
                             device=device)
    pad_len = torch.zeros((b,), dtype=torch.long, device=device) \
        if pad_len is None else torch.as_tensor(pad_len, device=device).long()
    cos_b, sin_b = rope_cache_for(bcfg, cache.capacity + 1, device)
    cos_d, sin_d = rope_cache_for(args.decoder_config,
                                  args.n_audio_codebooks + 1, device)
    if s > 1:
        last_hidden, cache = _prefill(model.params, args, tokens, token_mask,
                                      pad_len, cache, cos_b, sin_b)
    else:
        last_hidden, cache = _backbone_step(model.params, args, tokens,
                                            token_mask, pad_len, cache,
                                            cos_b, sin_b)
    frame, history = _decode_frame(model.params, args, last_hidden,
                                   generator, history, smp,
                                   tuple(logits_processors or ()), cos_d,
                                   sin_d)
    if return_state:
        return FrameState((frame, cache, generator, history))
    return frame


@torch.no_grad()
def stream_generate(
    model: CSM,
    text: str,
    speaker: int,
    context: Sequence = (),
    max_audio_length_ms: float = 90_000,
    *,
    temperature: float = 0.8,
    sampler: Optional[Any] = None,
    logits_processors: Optional[Sequence] = None,
    generator: Optional[torch.Generator] = None,
    mimi=None,
    _eager_step: bool = False,
) -> Iterator[torch.Tensor]:
    """Yield one 1,920-sample (80 ms at 24 kHz) chunk per generated frame,
    in JAX's argument order, `generator` in place of `key`.

    The prefill, the first frame and its Mimi decode step run eagerly; each
    later frame, with its decode step, is one `FrameStep` (a replayed CUDA
    graph on the card). The host reads each frame for EOS (an all-zero
    frame ends the stream, its chunk unsent) and copies the frame's chunk
    out before it launches the next frame, so the card makes frame i+1
    while the caller takes chunk i, a float tensor on the CPU. `mimi` is
    the codec that encodes the context's audio and decodes the frames, by
    default the `get_audio_tokenizer` singleton on the model's device."""
    args = model.args
    max_frames = int(max_audio_length_ms / FRAME_MS)
    codec = _codec_for(model, mimi)
    prompt, mask = _assemble_prompt(model, text, speaker, context, codec)
    _check_context_window(args, prompt.shape[0], max_frames)
    tokens, mask, pad_len, bucket = _pad_prompt(prompt, mask)
    with _frame_step(model, 1, bucket + max_frames,
                     _resolve_sampler(temperature, sampler),
                     tuple(logits_processors or ()), generator, codec=codec,
                     eager=_eager_step) as step:
        step.first(step.prefill(tokens, mask, pad_len))
        for i in range(max_frames):
            if not bool(step.frame.any()):
                break  # EOS; this frame's chunk is not sent
            # a copy, also on the CPU: the next frame overwrites the buffer
            chunk = step.chunk[0].to("cpu", copy=True)
            if i + 1 < max_frames:
                step()
            yield chunk
