"""Kernel 3's share of its roofline in the replayed graphs of the traced
stretch: the summed bound of its launches (`roofline.k3_bound_s` at the
graph's rows) over their summed device time, in %. Nothing when the
profiler kept fewer launches than the counters made."""

from gpubench import roofline
from gpubench.metrics_common import K3, roofline_share


def read(layer: dict):
    if "trace" not in layer:
        return None
    return roofline_share(layer, K3,
                          roofline.k3_bound_s(layer["config"], layer["rows"]))
