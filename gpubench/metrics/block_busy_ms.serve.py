"""Device-busy ms of one replayed engine block (K frames and the Mimi step
of the K frames owed, `continuous.py`): the union of the kernels each
block's cudaGraphLaunch ran, averaged over the complete blocks of the
traced stretch."""

from gpubench.metrics_common import replay_busy_ms


def read(layer: dict):
    return replay_busy_ms(layer)
