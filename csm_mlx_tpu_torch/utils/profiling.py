"""Profiling and tracing hooks (port of `csm_mlx_tpu/utils/profiling.py`).

- `trace(logdir)`: a context manager around `torch.profiler.profile` (the
  CPU, and the CUDA device when there is one) that writes a Chrome trace
  of everything inside into `logdir`, as TensorBoard's profiler plugin
  reads it (`<host>_<pid>.<time>.pt.trace.json`).
- `annotate(name)`: the port's span. While a torch profiler records, it is
  a `torch.profiler.record_function`, so the span lands in the same trace
  as the device events, on their clock, and the kernels launched inside it
  can be placed under it by their correlation ids; otherwise it is one
  shared no-op context (a flag read, well under a microsecond). Only the
  thread that started the profiler records its spans. A span's name is a
  fixed string: the exported trace keeps no arguments.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


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


def annotate(name: str) -> ContextManager:
    """A span named `name` while a profiler records, else a no-op. Never
    open one inside a region a CUDA graph captures (it would record at the
    capture only) nor across a generator's `yield`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
