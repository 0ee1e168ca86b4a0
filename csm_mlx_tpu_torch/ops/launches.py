"""The launch counters of the port's kernel wrappers, in one registry.

A wrapper adds one to its counter where it launches its kernel, and
nowhere else; it registers the counter here when its module is imported.
A replayed CUDA graph runs its kernels without calling their wrappers, so
`generation.FrameStep` reads this registry to add the launches its capture
recorded at every replay; a launch check sets every count to 0 before the
path it drives and reads them after."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

# counter name -> (wrapper, attribute)
COUNTERS: Dict[str, Tuple[Callable, str]] = {}


def register(fn: Callable, attr: str = "launches", name: str | None = None
             ) -> None:
    """Register `fn.<attr>` (set to 0) under `name` (by default the
    wrapper's name)."""
    setattr(fn, attr, 0)
    COUNTERS[name or fn.__name__] = (fn, attr)


def reset() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}
