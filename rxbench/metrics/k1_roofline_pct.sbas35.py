"""k1_roofline_pct.sbas35 (ops kernels layer): ``k1_roofline_pct``'s
reading in the SBAS cell: K1's bound over its device time across both
channel groups' traced super-steps, each counted at its own shape
(``rxbench/peaks.py``: the GPS group's 32 channels of 10 periods, the
SBAS group's 3 channels of 2 periods, 6 windows a launch).  Moves
rx_msps."""
from rxbench.metrics.k1_roofline_pct import read  # noqa: F401
