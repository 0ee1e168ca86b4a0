"""Driver `stream`: one client in a closed loop over
`generation.stream_generate`, as a voice app speaks a reply sentence by
sentence.

Each request builds its prompt from the mix (`traffic.py`) and hands it to
`stream_generate` through a stand-in for `tokenizers.tokenize_text_segment`
(the card's machine has no text tokenizer; it maps each segment's text to
its rows), with the mix's conversational context if it has one (the same
segments every request, their audio encoded anew by the call, as
`generate_long` and the voice chat do), reads its drawn number of 80 ms
chunks and closes the iterator. One `torch.Generator` serves the whole
run, as in a long-lived app, so the captured frame steps are reused.

The served tokens are read without changing what runs: the frame step the
call holds is wrapped (`_Recorder`) so that after its first frame and
after each later frame one device-side copy of the frame (32 codes) goes
into a buffer of the benchmark's own, read after the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from gpubench import checks, system, trace, traffic

FRAME_S = 0.08


class _Recorder:
    """A frame step seen through: `first` and each call also copy the new
    frame into `log` on the device."""

    def __init__(self, step, log):
        self._step, self._log = step, log

    def __getattr__(self, name):
        return getattr(self._step, name)

    def first(self, last_hidden):
        self._step.first(last_hidden)
        self._log.add(self._step.frame)

    def __call__(self):
        self._step()
        self._log.add(self._step.frame)


class FrameLog:
    def __init__(self, n: int, k: int, device):
        self.buf = torch.zeros((n, k), dtype=torch.long, device=device)
        self.n = 0

    def add(self, frame: torch.Tensor) -> None:
        if self.n < self.buf.shape[0]:
            self.buf[self.n].copy_(frame[0])
        self.n += 1


@contextlib.contextmanager
def instrumented(generation, tokenizers, log: FrameLog, holder: dict):
    """The stand-in tokenizer (a context segment's text gives its rows,
    any other text the request's prompt) and the frame recorder, installed
    for the block."""
    real_step = generation._frame_step
    real_tok = tokenizers.tokenize_text_segment

    @contextlib.contextmanager
    def recording(*a, **kw):
        with real_step(*a, **kw) as step:
            yield _Recorder(step, log)

    generation._frame_step = recording
    tokenizers.tokenize_text_segment = \
        lambda text, *a, **kw: holder["texts"].get(text, holder["prompt"])
    try:
        yield
    finally:
        generation._frame_step = real_step
        tokenizers.tokenize_text_segment = real_tok


def serve_one(generation, model, mimi, gen, req, temperature, max_ms,
              holder, log) -> dict:
    holder["prompt"] = (req.prompt, req.mask)
    rec = dict(prompt=req.prompt, mask=req.mask, greedy=req.greedy,
               want=req.frames, log_at=log.n, chunks=[], times=[],
               segments=holder["segments"],
               context=bool(holder["segments"]),
               rows=req.prompt.shape[0] + holder["context_rows"])
    t = 0.0 if req.greedy else temperature
    rec["t_submit"] = time.perf_counter()
    it = generation.stream_generate(model, "", 0, holder["context"],
                                    max_audio_length_ms=max_ms,
                                    temperature=t, generator=gen, mimi=mimi)
    try:
        for chunk in it:
            rec["times"].append(time.perf_counter())
            rec["chunks"].append(chunk)
            if len(rec["chunks"]) >= req.frames:
                break
    finally:
        it.close()
    return rec


def run(ctx) -> dict:
    from csm_mlx_tpu_torch import generation, tokenizers
    from csm_mlx_tpu_torch.ops import launches

    from csm_mlx_tpu_torch.segment import Segment

    cfg, mix, cell = ctx.config, ctx.mix, ctx.cell
    dev = ctx.device
    segments = traffic.context_audio(mix, cfg, ctx.seed)
    t_build = time.perf_counter()
    model = system.build_csm(cfg, ctx.seed, dev)
    mimi = system.build_mimi(cfg, ctx.seed, dev, encoder=bool(segments))
    ctx.sync()
    t_warm = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ctx.seed) % (1 << 63))
    temperature = float(mix["temperature"])
    max_ms = float(mix["max_audio_length_ms"])
    log = FrameLog(1 << 16, cfg["audio_num_codebooks"], dev)
    frame = mimi.frame_size
    holder = dict(
        segments=segments,
        texts={f"context {i}": (rows, mask)
               for i, (rows, mask, _) in enumerate(segments)},
        context=[Segment(i % 2, f"context {i}", audio)
                 for i, (_, _, audio) in enumerate(segments)],
        # text rows, one row a frame and the end-of-audio row, a segment
        context_rows=sum(len(rows) + -(-len(audio) // frame) + 1
                         for rows, _, audio in segments))
    reqs = traffic.generate(mix, cfg, ctx.seed, 4096, stream=1)
    warm_pool = traffic.generate(mix, cfg, ctx.seed, 512, stream=0)
    out: dict = {"layer": {}}
    with instrumented(generation, tokenizers, log, holder):
        # every (prompt bucket, sampler) the mix reaches, 4 frames each: the
        # step's eager first frame, its warm-up frame, its capture, a replay
        seen = set()
        for r in warm_pool:
            key = (generation.prompt_bucket(
                r.prompt.shape[0] + holder["context_rows"]), r.greedy)
            if key in seen:
                continue
            seen.add(key)
            r.frames = 4
            serve_one(generation, model, mimi, gen, r, temperature, max_ms,
                      holder, log)
        ctx.sync()
        out["setup_s"] = ctx.setup_done()
        ctx.log(f"[setup] {t_build - ctx.t_start:.2f} s to the model, "
                f"{t_warm - t_build:.2f} s weights, quantization, tables "
                f"and codec, {time.perf_counter() - t_warm:.2f} s warm-up "
                f"of {len(seen)} frame steps")

        served: List[dict] = []
        t0 = time.perf_counter()
        end = t0 + ctx.seconds
        traced = not ctx.trace
        i = 0
        while time.perf_counter() < end:
            if not traced and time.perf_counter() - t0 >= ctx.seconds / 3:
                traced = True
                out["layer"].update(_stretch(
                    ctx, generation, launches, model, mimi, gen, reqs, i,
                    temperature, max_ms, holder, log, served))
                i = len(served)
                continue
            served.append(serve_one(generation, model, mimi, gen, reqs[i],
                                    temperature, max_ms, holder, log))
            i += 1
        ctx.sync()
        t1 = time.perf_counter()
        out["memory_peak_bytes"] = ctx.memory_peak()
    frames = log.buf[:min(log.n, log.buf.shape[0])].cpu().numpy()
    model.frame_steps.clear()
    del model, mimi
    ctx.free()

    firsts, gaps, audio_s, failed = [], [], 0.0, 0
    for r in served:
        n = len(r["chunks"])
        r["frames"] = frames[r["log_at"]:r["log_at"] + n].astype(np.int32)
        r["audio"] = (torch.cat(r["chunks"]).numpy() if n
                      else np.zeros((0,), np.float32))
        if n == 0:
            failed += 1
            continue
        firsts.append(1e3 * (r["times"][0] - r["t_submit"]))
        gaps.extend(1e3 * np.diff(r["times"]))
        audio_s += n * FRAME_S
    window_s = t1 - t0
    out["e2e"] = {
        "rtf": audio_s / window_s,
        "first_chunk_p90_ms": ctx.quantile(firsts, 0.9),
        "chunk_gap_p95_ms": ctx.quantile(gaps, 0.95),
    }
    out["attempted"], out["failed"] = len(served), failed
    out["served"] = served
    picked = checks.sample(served, ctx.seed)
    out["readings"] = checks.readings(cfg, ctx.seed, picked, dev,
                                      control=ctx.control)
    out["readings"]["requests"] = len(picked)
    return out


def _stretch(ctx, generation, launches, model, mimi, gen, reqs, i,
             temperature, max_ms, holder, log, served) -> dict:
    """The traced stretch: whole requests until `trace_frames` frames have
    been replayed; what the per-layer readers read of it
    (`metrics_common`)."""
    want = int(ctx.cell["trace_frames"])
    before = launches.read()
    requests = []
    n_frames = 0
    with trace.padded() as held:
        t0 = time.perf_counter()
        while n_frames < want:
            r = serve_one(generation, model, mimi, gen, reqs[i], temperature,
                          max_ms, holder, log)
            served.append(r)
            i += 1
            n = len(r["chunks"])
            requests.append(dict(rows=r["rows"], prefill=True,
                                 frames=list(range(n))))
            # a closed stream has computed one frame past its last chunk
            n_frames += max(n - 1, 0)
        wall = time.perf_counter() - t0
    counts = {k: v - before.get(k, 0) for k, v in launches.read().items()}
    ctx.log(f"[trace stream] launch counters over the stretch {counts}")
    return dict(trace=held.trace, counts=counts, rows=1, config=ctx.config,
                span_s=wall, requests=requests)
