"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

From the root of a checkout: builds the port's CUDA kernels from
`csm_mlx_tpu_torch/csrc/`, holds each kernel against its plain PyTorch
version at the shapes of the main path, checks the port's main path on the
card against the CPU on a small model, then drives the main path at full
CSM-1B width — random weights from a seed, W8A8, greedy
`generate_tokens` for 125 frames (10 s of audio) from a 32-row prompt, a
300-row prompt that takes the flash-prefill kernel, and a Mimi decode to a
waveform — and checks that both kernels ran in it. Any failure raises; the
last line of standard output is then missing.

Prints the card's name and power limit, one line per kernel check, the
kernels' line `{"kernels": [...]}` and, last, `{"ok": true, "device":
{...}}`. Needs one CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from csm_mlx_tpu_torch import config as port_config  # noqa: E402
from csm_mlx_tpu_torch.generation import generate_tokens  # noqa: E402
from csm_mlx_tpu_torch.models.csm import CSM, ModelArgs, csm_1b  # noqa: E402
from csm_mlx_tpu_torch.models.mimi import Mimi, mimi_202407  # noqa: E402
from csm_mlx_tpu_torch.ops import _build  # noqa: E402
from csm_mlx_tpu_torch.ops import attention, quant  # noqa: E402

SEED = 0
W8A8_SHAPES = {  # (IN, OUT) of the main path's quantized linears
    "backbone qkv": (2048, 3072),
    "backbone gate-up": (2048, 16384),
    "backbone down": (8192, 2048),
    "decoder qkv": (1024, 1536),
    "projection": (2048, 1024),
}
W8A8_ROWS = (1, 8, 64, 512)  # decode batches, and prefill rows at 512
FLASH_CASES = [(s, dtype) for s in (256, 512)
               for dtype in (torch.bfloat16, torch.float32)]
FLASH_PADS = (0, 37, 200)
COLD_BYTES = 160 << 20  # weights cycled per timing run, > the 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(device ms, wall ms) of one call, each a mean over `reps` calls.

    Device ms: the summed duration of every kernel, copy and fill the
    calls ran on the card, from `torch.profiler` (device events only: the
    operator events that launched them carry the same time again) — at
    small shapes the host launches slower than the card computes, so the
    wall time is the host's. Wall ms: CUDA events around the `reps`
    calls. The profiler now and then records no device event in a
    window; it is asked up to three times, and if it still sees none the
    device ms is the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1000.0, wall
    return wall, wall


def check_w8a8(dev, gen) -> dict:
    """Kernel 1 vs `w8a8_matvec_plain` on bf16 activations. Both compute
    the same int32 products (exact) and the same fp32 fix-up, up to the
    order of the fp32 row sum; the outputs are then rounded to bf16, so
    they may differ by one bf16 step: tolerance 2**-7 of each value plus
    1e-3 of the output's largest magnitude."""
    worst, timing = 0.0, None
    for name, (in_dim, out_dim) in W8A8_SHAPES.items():
        w = torch.randn((out_dim, in_dim), generator=gen, device=dev) * 0.02
        copies = [quant.quantize_weight_w8(w)]
        n_copies = max(1, -(-COLD_BYTES // (in_dim * out_dim)))
        for _ in range(n_copies - 1):
            copies.append({k: v.clone() for k, v in copies[0].items()})
        for rows in W8A8_ROWS:
            x = torch.randn((rows, in_dim), generator=gen,
                            device=dev).to(torch.bfloat16)
            q = copies[0]
            got = quant.w8a8_matvec(x, q["weight_q"], q["scales"], q["biases"])
            want = quant.w8a8_matvec_plain(x, q["weight_q"], q["scales"],
                                           q["biases"])
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            scale = want.float().abs().max().item()
            bound = 2.0 ** -7 * want.float().abs() + 1e-3 * scale
            err = diff.max().item()
            ok = bool((diff <= bound).all()) and bool(torch.isfinite(got).all())
            it = iter(range(1 << 30))

            def run_kernel():
                c = copies[next(it) % n_copies]
                quant.w8a8_matvec(x, c["weight_q"], c["scales"], c["biases"])

            def run_plain():
                c = copies[next(it) % n_copies]
                quant.w8a8_matvec_plain(x, c["weight_q"], c["scales"],
                                        c["biases"])

            ms_k, wall_k = time_ms(run_kernel)
            ms_p, wall_p = time_ms(run_plain)
            gbs = in_dim * out_dim / (ms_k * 1e-3) / 1e9
            log(f"w8a8 {name:17s} B={rows:4d} IN={in_dim:5d} OUT={out_dim:5d}"
                f"  max_abs_err={err:.3e} (tol 2^-7*|y| + {1e-3 * scale:.2e})"
                f"  kernel {ms_k:.4f} ms device ({gbs:.0f} GB/s of weights),"
                f" {wall_k:.4f} ms wall  plain {ms_p:.4f} ms device,"
                f" {wall_p:.4f} ms wall  {'ok' if ok else 'MISMATCH'}")
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"w8a8 kernel disagrees at {name} B={rows}")
            if name == "backbone gate-up" and rows == 1:
                timing = (ms_k, ms_p)
        del copies
    # the JSON line times the widest decode matvec: B=1 on gate-up
    return dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


def check_flash(dev, gen) -> dict:
    """Kernel 2 vs `flash_prefill_plain` at B=2, H=32, n_kv=8, D=64, over
    k/v slices of a cache-shaped buffer, on rows past each pad. fp32:
    atol 1e-4 (sum order; exp). bf16: atol 3e-2 — the plain version rounds
    the probabilities to bf16 before P.V as the JAX sdpa does, the kernel
    keeps them in fp32, and both round the output to bf16."""
    worst, timing = 0.0, None
    b, h, n_kv, d = 2, 32, 8, 64
    for s, dtype in FLASH_CASES:
        for pad_row1 in FLASH_PADS:
            cap = s + 125
            q = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
            kc = torch.randn((b, n_kv, cap, d), generator=gen,
                             device=dev).to(dtype)
            vc = torch.randn((b, n_kv, cap, d), generator=gen,
                             device=dev).to(dtype)
            pads = (0, pad_row1)
            pad = torch.tensor(pads, dtype=torch.int32, device=dev)
            k, v = kc[:, :, :s], vc[:, :, :s]
            got = attention.flash_prefill_sdpa(q, k, v, d ** -0.5, pad)
            want = attention.flash_prefill_plain(q, k, v, d ** -0.5, pad)
            torch.cuda.synchronize()
            tol = 1e-4 if dtype == torch.float32 else 3e-2
            err = max((got[i, :, p:].float() - want[i, :, p:].float()).abs()
                      .max().item() for i, p in enumerate(pads))
            ok = err <= tol and bool(torch.isfinite(got).all())
            ms_k, wall_k = time_ms(lambda: attention.flash_prefill_sdpa(
                q, k, v, d ** -0.5, pad))
            ms_p, wall_p = time_ms(lambda: attention.flash_prefill_plain(
                q, k, v, d ** -0.5, pad))
            log(f"flash S={s} {str(dtype):14s} pads={pads}"
                f"  max_abs_err={err:.3e} (tol {tol:g})"
                f"  kernel {ms_k:.4f} ms device, {wall_k:.4f} ms wall"
                f"  plain {ms_p:.4f} ms device, {wall_p:.4f} ms wall"
                f"  {'ok' if ok else 'MISMATCH'}")
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"flash kernel disagrees at S={s} {dtype}")
            if s == 512 and dtype == torch.bfloat16 and pad_row1 == 200:
                timing = (ms_k, ms_p)
    # the JSON line times the main path's case: S=512 bf16 with a pad
    return dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


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


def params_to_cpu(tree):
    if isinstance(tree, dict):
        return {k: params_to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_cpu(v) for v in tree]
    return tree.cpu()


def check_small_vs_cpu(dev, mimi: Mimi) -> None:
    """The main path on a small model, W8A8, fp32, with a 300-row prompt:
    the card (both kernels) against the CPU (plain versions). The greedy
    frames agree on at least 99% of the codes, and the full-size Mimi
    decodes them alike on both (fp32, TF32 off: sum order only, so within
    1e-4 of the waveform's largest magnitude)."""
    port_config.BACKBONE_CONFIGURATION["smoke_small"] = port_config.LlamaConfig(
        vocab_size=1024, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=64, intermediate_size=512,
        hidden_size=256)
    port_config.DECODER_CONFIGURATION["smoke_small"] = port_config.LlamaConfig(
        vocab_size=1024, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=64, intermediate_size=256,
        hidden_size=128)
    args = ModelArgs("smoke_small", "smoke_small", 1024, 256, 32)
    gpu = random_csm(args, torch.float32, dev, SEED + 7)
    gpu.params["audio_head"] = gpu.params["audio_head"] * 25.0  # N(0, 0.5^2)
    quant.quantize_model(gpu, mode="w8a8", min_size=0)

    cpu = CSM(args, params=params_to_cpu(gpu.params), dtype=torch.float32)
    prompt, mask = synthetic_prompt(300, args.n_text_vocab, SEED + 8)
    launches = attention.flash_prefill_sdpa.launches
    f_gpu, n_gpu = generate_tokens(gpu, prompt, mask, 4, temperature=0.0)
    f_cpu, n_cpu = generate_tokens(cpu, prompt, mask, 4, temperature=0.0)
    if attention.flash_prefill_sdpa.launches == launches:
        raise AssertionError("small-model check did not take flash prefill")
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


def run_main_path(dev, mimi: Mimi) -> dict:
    """Drive the main path at full CSM-1B width; return each kernel's
    launch count in it."""
    args = csm_1b()
    t0 = time.perf_counter()
    model = random_csm(args, torch.bfloat16, dev, SEED)
    quant.quantize_model(model, mode="w8a8", fuse=True)
    torch.cuda.synchronize()
    log(f"CSM-1B random init (seed {SEED}) + W8A8: "
        f"{time.perf_counter() - t0:.1f} s")
    prompt, mask = synthetic_prompt(32, args.n_text_vocab, SEED)
    long_prompt, long_mask = synthetic_prompt(300, args.n_text_vocab, SEED + 1)
    generate_tokens(model, prompt, mask, 2, temperature=0.0)  # warm-up
    torch.cuda.synchronize()

    quant.w8a8_matvec.launches = 0
    attention.flash_prefill_sdpa.launches = 0
    t0 = time.perf_counter()
    frames, n = generate_tokens(model, prompt, mask, 125, temperature=0.0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_frames, n_long = generate_tokens(model, long_prompt, long_mask, 10,
                                          temperature=0.0)
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    codes = torch.from_numpy(frames.T[None].copy()).to(dev)
    t0 = time.perf_counter()
    audio = mimi.decode(codes)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    counts = {"w8a8_matvec": quant.w8a8_matvec.launches,
              "flash_prefill_sdpa": attention.flash_prefill_sdpa.launches}

    log(f"launches on the main path: {counts}")
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
    audio_sec = n * 0.08
    log(f"main path: {n} frames in {t_gen:.3f} s = {n / t_gen:.2f} frames/s,"
        f" RTF {audio_sec / t_gen:.3f} (generation), "
        f"{audio_sec / (t_gen + t_dec):.3f} (with Mimi decode {t_dec:.3f} s);"
        f" 300-row prompt: {n_long} frames in {t_long:.3f} s;"
        f" waveform {audio.shape[-1]} samples, finite")
    return counts


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

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    log(f"built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    w8a8 = check_w8a8(dev, gen)
    flash = check_flash(dev, gen)
    mimi = Mimi(mimi_202407(32), dtype=torch.float32,
                generator=torch.Generator(device=dev).manual_seed(SEED + 2),
                device=dev)
    check_small_vs_cpu(dev, mimi)
    launches = run_main_path(dev, mimi)

    kernels = [
        dict(name="w8a8_matvec", route="cuda",
             source="csm_mlx_tpu_torch/csrc/w8a8_matvec.cu",
             replaces="csm_mlx_tpu/ops/quant.py:152",
             launches=launches["w8a8_matvec"],
             max_abs_err=w8a8["max_abs_err"], ms=w8a8["ms"],
             plain_ms=w8a8["plain_ms"]),
        dict(name="flash_prefill_sdpa", route="cuda",
             source="csm_mlx_tpu_torch/csrc/flash_prefill.cu",
             replaces="csm_mlx_tpu/ops/attention.py:34",
             launches=launches["flash_prefill_sdpa"],
             max_abs_err=flash["max_abs_err"], ms=flash["ms"],
             plain_ms=flash["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
