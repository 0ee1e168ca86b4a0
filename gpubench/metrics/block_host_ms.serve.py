"""Ms a block that the device sits idle while the engine's thread works:
the traced stretch's device idle under an `engine.*` span
(`continuous.ContinuousEngine`; the innermost open, `spans.idle_under`)
other than `engine.fetch_wait` and `engine.idle` (waits on the device or
for requests), over the number of `engine.block` spans. Beside
`block_busy_ms.serve`: a block's wall is about the two summed, so this is
the part of the block's pace the engine's thread sets."""

from gpubench import spans

WAITS = ("engine.fetch_wait", "engine.idle", spans.NO_SPAN)


def read(layer: dict):
    sp = spans.of(layer)
    if sp is None:
        return None
    blocks = sp.named("engine.block")
    if not blocks:
        return None
    idle = sp.idle_under(prefix="engine.")
    work = sum(v for k, v in idle.items() if k not in WAITS)
    return work / len(blocks) / 1e3
