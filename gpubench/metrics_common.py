"""Helpers shared by the per-layer readers (`metrics/<metric>.py`).

A reader's `read(layer)` gets what its driver saw of the run, unreduced,
and returns its number or None where what it needs is not there:

- "trace": the traced stretch (`trace.Trace`; `--trace 1` runs only);
- "counts": the port's launch counters (`ops/launches.py`) over the
  stretch, where the thread that launched all of it read them at its ends;
  else None;
- "rows": the rows each replayed graph of the stretch runs (1 in a frame
  step; the slots in an engine block);
- "config": the cell's configuration;
- "span_s", "requests": a span of the run on the host's clock and each
  request served in it, as {"rows": prompt rows, "prefill": whether its
  prompt was run in the span, "frames": the positions after the prompt of
  the frames it delivered in the span};
- a driver's own counters (the engine's: "engine_counts",
  "admit_to_first_ms").
"""

from __future__ import annotations

from typing import List, Tuple

from gpubench import roofline, trace

K1 = ("w8a8_matvec_kernel", "w8a8_gemm_kernel")
K1_QUANT = ("quant_rows_kernel",)
K3 = ("resident_frame_kernel",)
# the launch counters of kernels 1 and 3
COUNTERS = {K1: "w8a8_matvec", K3: "resident_decode_frame"}


def replays(layer: dict) -> List[Tuple[list, int]]:
    """The replayed graphs of the stretch whose launches the profiler all
    kept: (the graph's kernels, the frames it ran), a frame being one
    kernel-3 launch with a backbone step's kernel-1 launches (as many as
    `roofline.k1_frame_bound_s` counts from the backbone's architecture)."""
    tr = layer.get("trace")
    if tr is None:
        return []
    _, per_frame = roofline.k1_frame_bound_s(layer["config"], layer["rows"])
    out = []
    for ks in tr.by_graph_launch().values():
        n = len(trace.named(ks, *K3))
        if n and len(trace.named(ks, *K1)) == n * per_frame:
            out.append((ks, n))
    return out


def gated(layer: dict) -> bool:
    """Whether the stretch's kernel shares count: the profiler kept as many
    launches of kernels 1 and 3 as the counters made (where the stretch has
    counters), and at least one replayed graph had all its launches."""
    tr = layer.get("trace")
    if tr is None or not replays(layer):
        return False
    counts = layer.get("counts") or {}
    for names, key in COUNTERS.items():
        counted = counts.get(key)
        if counted is not None and len(trace.named(tr.kernels, *names)) \
                != counted:
            return False
    return True


def roofline_share(layer: dict, names: tuple, bound_s_a_frame: float):
    """The summed bound of the complete replays' frames over the summed
    device time of their `names` kernels, in %; None unless `gated`."""
    if not gated(layer):
        return None
    reps = replays(layer)
    t = sum(e["dur"] for ks, _ in reps for e in trace.named(ks, *names))
    if not t:
        return None
    return 100.0 * sum(n for _, n in reps) * bound_s_a_frame / (t / 1e6)


def replay_busy_ms(layer: dict):
    """Device-busy ms of one complete replay (the union of its kernels),
    averaged over the stretch's complete replays."""
    reps = replays(layer)
    if not reps:
        return None
    tr = layer["trace"]
    return sum(tr.busy_us(ks, clip=False) for ks, _ in reps) / len(reps) / 1e3


def idle_share(layer: dict):
    """1 - (union of the device events' intervals) / (the stretch), in %."""
    tr = layer.get("trace")
    if tr is None or not tr.window_us:
        return None
    return 100.0 * (1.0 - tr.busy_us(tr.kernels) / tr.window_us)


def model_ops(layer: dict) -> float:
    """The CSM model's operations of the span's requests
    (`roofline.prefill_ops` for each prompt run in the span,
    `roofline.frame_ops` for each frame delivered in it; Mimi left out)."""
    cfg = layer["config"]
    ops = 0.0
    for r in layer.get("requests") or ():
        if r["prefill"]:
            ops += roofline.prefill_ops(cfg, r["rows"])
        ops += sum(roofline.frame_ops(cfg, r["rows"] + j)
                   for j in r["frames"])
    return ops


def mfu(layer: dict, kind: str):
    """`model_ops` over the span's wall time against the card's `kind`
    peak, in %."""
    if not layer.get("span_s") or not layer.get("requests"):
        return None
    return (100.0 * model_ops(layer) / layer["span_s"]
            / roofline.PEAK_OPS_PER_S[kind])
