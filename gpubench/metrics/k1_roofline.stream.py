"""Kernel 1's share of its roofline in the replayed graphs of the traced
stretch: the summed bound of each frame's kernel-1 launches
(`roofline.k1_frame_bound_s`: the backbone's fused qkv, o, gate-up and
down at the graph's rows, the projection at twice them) over the summed
device time of its row quantization and its product kernels, in %.
Nothing when the profiler kept fewer launches than the counters made."""

from gpubench import roofline
from gpubench.metrics_common import K1, K1_QUANT, roofline_share


def read(layer: dict):
    if "trace" not in layer:
        return None
    bound, _ = roofline.k1_frame_bound_s(layer["config"], layer["rows"])
    return roofline_share(layer, K1 + K1_QUANT, bound)
