"""device_idle_pct.sbas35 (device layer): the share of the SBAS cell's
traced window in which no kernel, copy or set ran on the card (the union
of the device intervals of the profiler's trace).  Moves rx_msps."""
from rxbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
