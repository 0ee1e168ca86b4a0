"""Median ms the device is idle between two frames of a stream: over each
pair of consecutive `stream.replay` spans of one request in the traced
stretch, the device-idle time between the last device event the first
launched and the first the second launched (the host's EOS read, the
chunk's copy, the next replay's launch; `generation.stream_generate`)."""

from statistics import median

from gpubench import spans


def read(layer: dict):
    sp = spans.of(layer)
    if sp is None:
        return None
    ms = []
    for req in sp.requests():
        frames = [sp.launched([r]) for r in req.get("stream.replay", ())]
        for a, b in zip(frames, frames[1:]):
            if a and b:
                lo = max(map(spans.end, a))
                hi = min(e["ts"] for e in b)
                ms.append(sp.device_idle_us(lo, hi) / 1e3)
    return median(ms) if ms else None
