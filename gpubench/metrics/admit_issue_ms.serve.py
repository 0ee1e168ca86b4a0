"""Median wall ms of an `engine.admit` span in the traced stretch: the
engine thread's issue of one admission batch (prefill, splice, first
frame; `continuous.ContinuousEngine`), which every stream waits behind."""

from statistics import median

from gpubench import spans


def read(layer: dict):
    sp = spans.of(layer)
    if sp is None:
        return None
    ms = [e["dur"] / 1e3 for e in sp.named("engine.admit")]
    return median(ms) if ms else None
