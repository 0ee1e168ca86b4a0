"""The whole step's share of the card's int8 peak over the window: the
CSM model's operations of the frames delivered in it and of the prompts
admitted in it (`roofline.frame_ops`, `roofline.prefill_ops`; Mimi left
out, dead slots' frames not counted) over the window's wall time, against
1,979 TOP/s, in %."""

from gpubench.metrics_common import mfu


def read(layer: dict):
    return mfu(layer, "int8")
