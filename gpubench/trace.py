"""The traced stretch: `torch.profiler` over a steady part of the window,
read back from its Chrome trace.

`padded` is frozen from `chip_smoke.py`: the card is synchronized before
the profiler starts and after the body, with 0.1 s of idle host time at
each end, because the profiler keeps a device event only when its
timestamps, mapped onto the host's clock, fall inside its window and that
mapping can read early or late. The body runs under a host span
(`STRETCH`) whose interval is the stretch: busy and idle are taken inside
it, the pads left out.

The trace's device events carry the correlation id of the host call that
launched them; every kernel a replayed CUDA graph runs carries the id of
its `cudaGraphLaunch`, which is how replayed frames and blocks are told
from the eager work around them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

import torch

PAD_S = 0.1
MARK = "gpubench synchronized"
STRETCH = "gpubench stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    """A padded profiler window opened by `start` and closed by `stop`, both
    on the one thread that launches the work (a profiler stopped while
    another thread replays a CUDA graph can deadlock in CUPTI)."""

    def __init__(self):
        self.prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        _sync()
        self.prof.__enter__()
        time.sleep(PAD_S)
        self._span = record_function(STRETCH)
        self._span.__enter__()

    def stop(self) -> None:
        from torch.profiler import record_function

        _sync()
        self._span.__exit__(None, None, None)
        with record_function(MARK):
            pass
        time.sleep(PAD_S)
        self.prof.__exit__(None, None, None)

    def trace(self) -> "Trace":
        return Trace.from_profiler(self.prof)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def padded():
    """Profile the body (CPU and CUDA activities) between two pads; yields
    a holder whose `.trace` is the parsed `Trace` after the block."""
    holder = type("Holder", (), {"trace": None})()
    stretch = Stretch()
    stretch.start()
    yield holder
    stretch.stop()
    holder.trace = stretch.trace()


class Trace:
    """Device events, host events and graph launches of one stretch, in
    microseconds on the trace's clock."""

    def __init__(self, events: List[dict]):
        self.kernels: List[dict] = []
        self.host: List[dict] = []
        self.graph_launches: Dict[int, dict] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.kernels.append(e)
            elif cat in ("cuda_runtime", "cuda_driver"):
                if e.get("name", "").startswith("cudaGraphLaunch"):
                    corr = e.get("args", {}).get("correlation")
                    if corr is not None:
                        self.graph_launches[corr] = e
                self.host.append(e)
            else:
                self.host.append(e)
        self.kernels.sort(key=lambda e: e["ts"])
        span = [e for e in self.host if e.get("name") == STRETCH]
        self.t0 = span[0]["ts"] if span else min(
            e["ts"] for e in self.kernels)
        self.t1 = (span[0]["ts"] + span[0]["dur"]) if span else max(
            e["ts"] + e["dur"] for e in self.kernels)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"gpubench_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def by_graph_launch(self) -> Dict[int, List[dict]]:
        """Kernels of each replayed graph, by its launch's correlation."""
        out: Dict[int, List[dict]] = defaultdict(list)
        for e in self.kernels:
            corr = e.get("args", {}).get("correlation")
            if corr in self.graph_launches:
                out[corr].append(e)
        return dict(out)

    def in_stretch(self, events: Iterable[dict]) -> List[dict]:
        return [e for e in events
                if e["ts"] + e["dur"] > self.t0 and e["ts"] < self.t1]

    def busy_us(self, events: Iterable[dict], clip: bool = True) -> float:
        return sum(b - a for a, b in union(events, self.t0 if clip else None,
                                           self.t1 if clip else None))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretch's intervals with no device event."""
        gaps, at = [], self.t0
        for a, b in union(self.kernels, self.t0, self.t1):
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def host_ops_at(self, times: List[float], scan: int = 400) -> List[str]:
        """The innermost host event under way at each time (the latest
        started of those that contain it, outside the profiler's own
        spans), or "host idle"."""
        import bisect

        host = sorted((e for e in self.host
                       if e.get("name") not in (STRETCH, MARK)
                       and not e.get("name", "").startswith("ProfilerStep")),
                      key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        out = []
        for t in times:
            name = "host idle"
            i = bisect.bisect_right(starts, t) - 1
            for e in host[max(i - scan, -1) + 1:i + 1][::-1]:
                if e["ts"] + e["dur"] > t:
                    name = e["name"]
                    break
            out.append(name)
        return out

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took the most time, by name, and the
        idle gaps by the host op under way at their middle, each summed in
        seconds."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.in_stretch(self.kernels):
            ops[short_name(e["name"])] += e["dur"] / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        idle = self.idle_gaps()
        names = self.host_ops_at([(a + b) / 2 for a, b in idle])
        for (a, b), name in zip(idle, names):
            gaps[name] += (b - a) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in worst]}


def union(events: Iterable[dict], lo: Optional[float] = None,
          hi: Optional[float] = None) -> List[Tuple[float, float]]:
    spans = []
    for e in events:
        a, b = e["ts"], e["ts"] + e["dur"]
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b > a:
            spans.append((a, b))
    spans.sort()
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    if name.startswith("void "):
        name = name[5:]
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:64] or "unnamed"


def named(kernels: Iterable[dict], *parts: str) -> List[dict]:
    return [e for e in kernels if any(p in e["name"] for p in parts)]
