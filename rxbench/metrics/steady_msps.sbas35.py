"""steady_msps.sbas35 (track steady layer): ``steady_msps``'s reading in
the SBAS cell, where a block steps the 32-channel GPS group (40
super-steps of 10 periods) and the SBAS group (200 super-steps of 2
periods) in lockstep.  Moves rx_msps."""
from rxbench.metrics.steady_msps import read  # noqa: F401
