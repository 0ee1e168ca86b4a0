"""The whole step's share of the card's int8 peak over the traced
stretch: the CSM model's operations of the requests served in it
(`roofline.prefill_ops` and `roofline.frame_ops`: backbone, heads,
projection, decoder; Mimi left out) over the stretch's wall time, against
1,979 TOP/s, in %."""

from gpubench.metrics_common import mfu


def read(layer: dict):
    return mfu(layer, "int8")
