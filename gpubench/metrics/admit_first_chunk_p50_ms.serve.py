"""Median ms from a request's admission into a slot to its first chunk,
over the window's requests (the engine's per-request stamps, which
ContinuousStats.admit_to_first_chunk also collects)."""

import numpy as np


def read(layer: dict):
    ms = layer.get("admit_to_first_ms")
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms, np.float64), 50))
