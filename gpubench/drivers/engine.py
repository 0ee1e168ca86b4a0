"""Driver `engine`: closed-loop clients on the port's `ContinuousEngine`,
as a TTS service on one card runs it.

The engine is built as `ContinuousTTSServer` builds it (slots, K frames a
block, prompt buckets, the transfer type from the cell's file), with the
run's seeded Mimi, and runs its own thread (`start`). Each of the mix's
clients submits its next request through `submit_prompt` from the done
callback of its last one, so no client thread runs; chunks are taken by a
chunk callback that stamps their arrival. The set-up runs the same mix
(requests of their own) until a stretch of blocks captures no new graph,
so that no capture lands in the window; the window then starts without a
pause. Requests submitted in the window are the ones measured; the clients
keep the load on until the last of them has finished, then the rest are
cancelled and the engine stopped.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np
import torch

from gpubench import checks, system, trace, traffic

FRAME_S = 0.08
STRETCH_TIMEOUT_S = 60


class Tracer:
    """The traced stretch, opened and closed from the chunk callbacks, so on
    the engine's own thread: `arm` asks for it; the next chunk opens the
    padded profiler and the first chunk after `blocks` + 1 more blocks were
    dispatched closes it."""

    def __init__(self, stats, blocks: int):
        self.stats, self.blocks = stats, blocks
        self.state = "idle"
        self.stretch = trace.Stretch()
        self.start_steps = 0
        self.done = threading.Event()

    def arm(self) -> None:
        self.state = "armed"

    def poll(self) -> None:
        if self.state == "armed":
            self.state = "on"
            self.stretch.start()
            self.start_steps = self.stats.steps
        elif self.state == "on" \
                and self.stats.steps - self.start_steps >= self.blocks + 1:
            self.stretch.stop()
            self.state = "done"
            self.done.set()


class Clients:
    """The closed loop: `n` clients, each sending its next request when the
    last one completes; requests come from the warm-up list until `switch`
    is called, then from the window list."""

    def __init__(self, eng, warm: list, window: list):
        self.eng = eng
        self.lists = [warm, window]
        self.phase = 0
        self.next = [0, 0]
        self.lock = threading.Lock()
        self.records: List[dict] = []
        self.closed = False
        self.t_end = None
        self.tracer = None

    def switch(self, t_end: float) -> None:
        with self.lock:
            self.phase, self.t_end = 1, t_end

    def submit(self) -> None:
        with self.lock:
            if self.closed:
                return
            phase = self.phase
            lst = self.lists[phase]
            req = lst[self.next[phase] % len(lst)]
            self.next[phase] += 1
            rec = dict(prompt=req.prompt, mask=req.mask, greedy=req.greedy,
                       context=req.context, want=req.frames, chunks=[],
                       times=[], phase=phase,
                       t_submit=time.perf_counter())
            rec["res"] = res = self.eng.submit_prompt(
                req.prompt, req.mask, max_frames=req.frames)
            self.records.append(rec)

        def on_chunk(chunk):
            if chunk is not None:
                rec["times"].append(time.perf_counter())
                rec["chunks"].append(chunk)
            if self.tracer is not None:
                self.tracer.poll()

        res.set_chunk_callback(on_chunk)
        res.add_done_callback(self.submit)

    def window_records(self) -> List[dict]:
        with self.lock:
            return [r for r in self.records
                    if r["phase"] == 1 and r["t_submit"] < self.t_end]


def run(ctx) -> dict:
    from csm_mlx_tpu_torch.continuous import ContinuousEngine
    from csm_mlx_tpu_torch.ops.attention import kv_prefix_buckets

    cfg, mix, cell = ctx.config, ctx.mix, ctx.cell
    dev = ctx.device
    ec = cell["engine"]
    t_build = time.perf_counter()
    model = system.build_csm(cfg, ctx.seed, dev)
    mimi = system.build_mimi(cfg, ctx.seed, dev)
    ctx.sync()
    ctx.log(f"[setup] {t_build - ctx.t_start:.2f} s to the model, "
            f"{time.perf_counter() - t_build:.2f} s weights, quantization, "
            f"tables and codec")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(ctx.seed) % (1 << 63))
    eng = ContinuousEngine(
        model, n_slots=ec["n_slots"],
        max_frames=int(mix["max_audio_length_ms"] / 80),
        max_prompt_bucket=ec["max_prompt_bucket"],
        temperature=float(mix["temperature"]), codec=True,
        frames_per_step=ec["frames_per_step"], transfer=ec["transfer"],
        generator=gen, mimi=mimi, eager=dev.type != "cuda")
    n_clients = int(mix["clients"])
    clients = Clients(eng, traffic.generate(mix, cfg, ctx.seed, 4096, 0),
                      traffic.generate(mix, cfg, ctx.seed, 8192, 1))
    st = eng.stats
    eng.start()
    out: dict = {"layer": {}}
    try:
        # set-up: the mix until every KV bucket the engine's blocks read
        # has its graph and `stable_blocks` blocks captured nothing new
        w = cell["warmup"]
        t_w = time.perf_counter()
        for _ in range(n_clients):
            clients.submit()
        want = 0 if dev.type != "cuda" else len(
            [b for b in kv_prefix_buckets(eng.capacity)
             if b > ec["max_prompt_bucket"]]) or 1
        last_cap, last_steps = st.graph_captures, st.steps
        while True:
            time.sleep(0.05)
            if eng._dead is not None:
                raise RuntimeError("the engine died in warm-up") \
                    from eng._dead
            if st.graph_captures != last_cap:
                last_cap, last_steps = st.graph_captures, st.steps
            waited = time.perf_counter() - t_w
            if (waited >= w["min_s"] and st.graph_captures >= want
                    and st.steps - last_steps >= w["stable_blocks"]) \
                    or waited >= w["max_s"]:
                break
        out["setup_s"] = ctx.setup_done()
        out["warmup"] = dict(captures=st.graph_captures, blocks=st.steps,
                             seconds=time.perf_counter() - t_w)
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        clients.switch(t_end)
        s0 = (st.steps, st.frames_emitted)
        captures0 = st.graph_captures
        if ctx.trace:
            clients.tracer = Tracer(st, int(cell["trace_blocks"]))
            time.sleep(ctx.seconds / 3)
            clients.tracer.arm()
            if not clients.tracer.done.wait(STRETCH_TIMEOUT_S):
                raise RuntimeError("the traced stretch did not close")
        time.sleep(max(t_end - time.perf_counter(), 0))
        s1 = (st.steps, st.frames_emitted)
        out["window_captures"] = st.graph_captures - captures0
        # keep the load on until every window request has finished
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            if all(r["res"].done.is_set() for r in clients.window_records()):
                break
            time.sleep(0.05)
        ctx.sync()
        out["memory_peak_bytes"] = ctx.memory_peak()
    finally:
        with clients.lock:
            clients.closed = True
        for r in clients.records:
            r["res"].cancel()
        eng.stop()
    k, slots = ec["frames_per_step"], ec["n_slots"]
    if clients.tracer is not None:
        # the engine's thread launches the stretch's work, so no launch
        # counts are taken at its ends
        out["layer"].update(trace=clients.tracer.stretch.trace(), counts=None,
                            rows=slots)
    recs = clients.window_records()
    del eng, model, mimi
    ctx.free()

    firsts, gaps, failed, audio_s, requests = [], [], 0, 0.0, []
    for r in clients.records:
        in_window = [j for j, t in enumerate(r["times"]) if t0 <= t < t_end]
        audio_s += FRAME_S * len(in_window)
        admitted = r["res"].t_admitted
        requests.append(dict(
            rows=int(r["prompt"].shape[0]), frames=in_window,
            prefill=admitted is not None and t0 <= admitted < t_end))
    for r in recs:
        res = r["res"]
        r["frames"] = res.token_matrix()
        r["audio"] = (np.concatenate(r["chunks"]) if r["chunks"]
                      else np.zeros((0,), np.float32))
        n = len(r["chunks"])
        if res.error is not None or n == 0 or n != len(r["frames"]) \
                or res.finish_reason not in ("cap", "eos"):
            failed += 1
            continue
        firsts.append(1e3 * (r["times"][0] - r["t_submit"]))
        gaps.extend(1e3 * np.diff(r["times"]))
    out["e2e"] = {
        "rtf": audio_s / (t_end - t0),
        "first_chunk_p90_ms": ctx.quantile(firsts, 0.9),
        "chunk_gap_p95_ms": ctx.quantile(gaps, 0.95),
    }
    admit = [1e3 * (r["res"].t_first_chunk - r["res"].t_admitted)
             for r in recs if r["res"].t_admitted is not None
             and r["res"].t_first_chunk is not None]
    out["layer"].update(
        config=cfg, span_s=t_end - t0, requests=requests,
        engine_counts=dict(steps=s1[0] - s0[0], frames_emitted=s1[1] - s0[1],
                           frames_per_step=k, n_slots=slots),
        admit_to_first_ms=admit)
    out["attempted"], out["failed"] = len(recs), failed
    picked = checks.sample([r for r in recs if len(r["chunks"])], ctx.seed)
    out["readings"] = checks.readings(cfg, ctx.seed, picked, dev,
                                      control=ctx.control)
    out["readings"]["requests"] = len(picked)
    ctx.log(f"[engine] warm-up {out['warmup']}; window {len(recs)} requests, "
            f"{s1[0] - s0[0]} blocks, captures in the window "
            f"{out['window_captures']}")
    return out

