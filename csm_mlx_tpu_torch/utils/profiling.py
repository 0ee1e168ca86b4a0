"""Profiling and tracing hooks (port of `csm_mlx_tpu/utils/profiling.py`).

- `trace(logdir)`: a context manager around `torch.profiler.profile` (the
  CPU, and the CUDA device when there is one) that writes a Chrome trace
  of everything inside into `logdir`, as TensorBoard's profiler plugin
  reads it (`<host>_<pid>.<time>.pt.trace.json`).
- `annotate(name)`: a span in that trace (`torch.profiler.record_function`)
  that also pushes an NVTX range when CUDA is present.
- `RtfMeter`: running real-time factor and first-chunk latency of a
  generation loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@dataclass
class RtfMeter:
    """Tracks frames emitted vs wall time -> RTF, plus first-chunk latency."""

    frame_seconds: float = 0.08
    _start: Optional[float] = None
    _frames: int = 0
    _first_chunk_s: Optional[float] = None
    history: List[float] = field(default_factory=list)

    def start(self) -> None:
        self._start = time.perf_counter()
        self._frames = 0
        self._first_chunk_s = None

    def tick(self, n_frames: int = 1) -> None:
        if self._start is None:
            # auto-starting here would time from inside the first tick: the
            # first-chunk latency would read ~0 and the slowest frame would
            # drop out of the RTF
            raise RuntimeError("RtfMeter.tick() before start()")
        self._frames += n_frames
        if self._first_chunk_s is None:
            self._first_chunk_s = time.perf_counter() - self._start

    def stop(self) -> float:
        if self._start is None:
            # stop() without (or twice per) start() would append an RTF
            # measured from nothing
            raise RuntimeError("RtfMeter.stop() before start()")
        elapsed = time.perf_counter() - self._start
        self._start = None
        rtf = (self._frames * self.frame_seconds) / elapsed if elapsed else 0.0
        self.history.append(rtf)
        return rtf

    @property
    def first_chunk_latency_s(self) -> Optional[float]:
        return self._first_chunk_s
