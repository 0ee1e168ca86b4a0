"""Device-busy ms of one replayed frame step (`generation.FrameStep`):
the union of the kernels each cudaGraphLaunch of the traced stretch ran,
averaged over the replays whose launches the profiler all kept."""

from gpubench.metrics_common import replay_busy_ms, replays


def read(layer: dict):
    reps = replays(layer)
    if not reps or any(n != 1 for _, n in reps):
        return None
    return replay_busy_ms(layer)
