"""Share of the traced stretch in which no operation ran on the device:
1 - (union of the device events' intervals) / (the stretch's length),
in %."""

from gpubench.metrics_common import idle_share


def read(layer: dict):
    return idle_share(layer)
