"""device_idle_pct.cold (device layer): the share of the traced window in
which no kernel, copy or set ran on the card (the union of the device
intervals of the profiler's trace).  Moves first_epoch_s."""
from rxbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
