"""The port's spans (`csm_mlx_tpu_torch.utils.profiling.annotate`) in a
traced stretch (`trace.Trace`), and the device work launched under them.

A span is a host event of the category "user_annotation" on the thread
that opened it; the trace keeps its name, its times and its thread, no
arguments. The device events a span launched are those whose correlation
id is that of a runtime call (category "cuda_runtime" or "cuda_driver")
made on the span's thread while it was open: a replayed graph's kernels
carry the id of its `cudaGraphLaunch`, an eager kernel or copy that of
its own launch. Only spans wholly inside the stretch are read (a span the
profiler's stop cut short ends past it).

Run as a script, it traces one cell over a longer stretch than the cell
file's and prints one JSON line: the device idle by the innermost span,
each span's count and wall time, the cell's per-layer metrics on that
stretch and, in a stream cell, each request's prefill and context encode:

    python3 -m gpubench.spans --workload <cell> --seed <n> --seconds <s> \
        --stretch <frames of a stream cell, blocks of the serve cell>
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from gpubench import trace

SPAN_CAT = "user_annotation"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "no span"


def end(e: dict) -> float:
    return e["ts"] + e["dur"]


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


class Spans:
    """The spans of one traced stretch, with its runtime calls and the
    union of its device events indexed by time."""

    def __init__(self, tr: trace.Trace):
        self.tr = tr
        self.spans = sorted(
            (e for e in tr.host if e.get("cat") == SPAN_CAT
             and e["ts"] >= tr.t0 and end(e) <= tr.t1),
            key=lambda e: e["ts"])
        self.runtime = sorted(
            (e for e in tr.host if e.get("cat") in RUNTIME_CATS
             and "correlation" in e.get("args", {})),
            key=lambda e: e["ts"])
        self._runtime_ts = [e["ts"] for e in self.runtime]
        self.busy = trace.union(tr.kernels)
        self._busy_ts = [a for a, _ in self.busy]

    def named(self, *names: str, prefix: Optional[str] = None) -> List[dict]:
        """The spans called one of `names`, or whose name starts with
        `prefix`, by start."""
        return [e for e in self.spans if e["name"] in names
                or (prefix is not None and e["name"].startswith(prefix))]

    def launched(self, spans: Iterable[dict]) -> List[dict]:
        """The device events launched under any of `spans`, by start."""
        corr = set()
        for s in spans:
            lo = bisect.bisect_left(self._runtime_ts, s["ts"])
            hi = bisect.bisect_right(self._runtime_ts, end(s))
            corr.update(e["args"]["correlation"]
                        for e in self.runtime[lo:hi]
                        if _thread(e) == _thread(s))
        return [k for k in self.tr.kernels
                if k.get("args", {}).get("correlation") in corr]

    def requests(self) -> List[Dict[str, List[dict]]]:
        """The stream's requests, one at a time: the `stream.*` spans from
        one `stream.assemble` to the next, by name."""
        out: List[Dict[str, List[dict]]] = []
        for s in self.named(prefix="stream."):
            if s["name"] == "stream.assemble":
                out.append({})
            if out:
                out[-1].setdefault(s["name"], []).append(s)
        return out

    def device_idle_us(self, lo: float, hi: float) -> float:
        """Microseconds of [lo, hi) in which no device event ran."""
        if hi <= lo:
            return 0.0
        covered = 0.0
        i = max(bisect.bisect_right(self._busy_ts, lo) - 1, 0)
        for a, b in self.busy[i:]:
            if a >= hi:
                break
            covered += max(0.0, min(b, hi) - max(a, lo))
        return hi - lo - covered


    def idle_under(self, *names: str,
                   prefix: Optional[str] = None) -> Dict[str, float]:
        """Microseconds of the stretch's device idle by the innermost of
        the chosen spans (`named`) open at the time, the latest started of
        those that contain it; `NO_SPAN` where none is."""
        chosen = sorted(self.named(*names, prefix=prefix),
                        key=lambda e: (e["ts"], -e["dur"]))
        gaps = self.tr.idle_gaps()
        bounds = sorted({p for e in chosen for p in (e["ts"], end(e))}
                        | {p for g in gaps for p in g})
        ends = sorted(range(len(chosen)), key=lambda i: end(chosen[i]))
        out: Dict[str, float] = defaultdict(float)
        open_: List[int] = []
        si = ei = gi = 0
        for a, b in zip(bounds, bounds[1:]):
            while si < len(chosen) and chosen[si]["ts"] <= a:
                open_.append(si)
                si += 1
            while ei < len(ends) and end(chosen[ends[ei]]) <= a:
                open_.remove(ends[ei])
                ei += 1
            while gi < len(gaps) and gaps[gi][1] <= a:
                gi += 1
            if gi < len(gaps) and gaps[gi][0] <= a:
                name = chosen[open_[-1]]["name"] if open_ else NO_SPAN
                out[name] += b - a
        return dict(out)

def of(layer: dict) -> Optional[Spans]:
    """The spans of a run's traced stretch; None without one."""
    tr = layer.get("trace")
    return Spans(tr) if tr is not None else None


def request_phases_ms(sp: Spans) -> Dict[str, List[float]]:
    """Each stream request's `prefill`, from its `stream.prefill`'s start
    to the end of the last device event launched under it or
    `stream.first`, and `encode`, from its first `stream.encode`'s start
    to the later of its last one's end and the end of the device work
    launched under them, in ms."""
    out: Dict[str, List[float]] = {"prefill": [], "encode": []}
    for req in sp.requests():
        pre, first = req.get("stream.prefill"), req.get("stream.first")
        dev = sp.launched(pre + first) if pre and first else []
        if dev:
            out["prefill"].append(
                (max(map(end, dev)) - pre[0]["ts"]) / 1e3)
        enc = req.get("stream.encode")
        if enc:
            stop = max(map(end, enc + sp.launched(enc)))
            out["encode"].append((stop - enc[0]["ts"]) / 1e3)
    return out


def _summary(values: List[float]) -> dict:
    out = {"n": len(values)}
    if len(values) >= 2:
        q1, q2, q3 = statistics.quantiles(values, n=4)
        out.update(q1=q1, median=q2, q3=q3, min=min(values), max=max(values))
    return out


def report(cell, layer: dict) -> dict:
    """What the script prints of a traced run of `cell` (`run.Cell`)."""
    tr = layer["trace"]
    sp = Spans(tr)
    prefix = "stream." if "trace_frames" in cell.cell else "engine."
    walls: Dict[str, List[float]] = defaultdict(list)
    for e in sp.named(prefix=prefix):
        walls[e["name"]].append(e["dur"] / 1e3)
    under = sp.idle_under(prefix=prefix)
    out = {
        "window_ms": tr.window_us / 1e3,
        "busy_ms": tr.busy_us(tr.kernels) / 1e3,
        "idle_ms_under": {k: v / 1e3 for k, v in
                          sorted(under.items(), key=lambda kv: -kv[1])},
        "spans": {k: {"count": len(v), "wall_ms": sum(v)}
                  for k, v in sorted(walls.items())},
        "breakdown_idle_s": tr.breakdown()["idle_gaps"],
        "metrics": {m["name"]: cell.reader(m["name"]).read(layer)
                    for m in cell.per_layer()},
    }
    if prefix == "stream.":
        out["requests"] = len(sp.requests())
        out["request_ms"] = {k: _summary(v)
                             for k, v in request_phases_ms(sp).items() if v}
    return out


def main(argv=None) -> int:
    from gpubench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stretch", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    cell = run.Cell(args.workload)
    key = "trace_frames" if "trace_frames" in cell.cell else "trace_blocks"
    cell.cell[key] = args.stretch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run.run_cell(cell, args.seed, args.seconds, True,
                       torch.device("cuda", 0))
    line = dict(workload=args.workload, seed=args.seed,
                **{key: args.stretch})
    line.update(report(cell, res["layer"]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
