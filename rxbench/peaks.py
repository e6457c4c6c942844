"""The card's published peaks and the work of K1, the band correlator.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA data sheet):
HBM3 at 3.35 TB/s, 67 TFLOP/s of float32 outside the tensor cores.

:func:`k1_work` is a frozen copy of the count the receiver package's card
check applies to one K1 launch (the block samples the active windows
cover, read once, as float32; their int8 replica rows; 17 bytes of scalars
per window; the 2 x taps float32 sums written; 4 x taps + 2 operations per
active real sample, 4 x taps + 6 per I/Q sample), applied here to the
windows a super-step of a channel group needs, from the problem's shapes
alone: so it reads the same work whatever implements the correlator.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def k1_work(*, channels: int, active: int, periods: int, nsamp: int,
            taps: int, smax: int, iq: bool = False) -> tuple[float, float]:
    """(bytes, float32 operations) of one super-step's correlation: a group
    of ``channels`` channels, ``active`` of them tracking, ``periods`` code
    periods of ``nsamp`` samples each, ``taps`` taps at most ``smax``
    samples from prompt.  The active windows of one channel are
    consecutive periods, and a group's channels lie within one period of
    each other, so the samples they cover are at least ``periods`` x
    ``nsamp`` (the least count is taken)."""
    windows = channels * periods
    nv = active * periods
    comp = 2 if iq else 1
    union = periods * nsamp if active else 0
    row = nsamp + 8 + 2 * smax          # a replica row: the window + 2 smax
    nbytes = (union * 4 * comp + nv * row
              + windows * 17 + windows * 2 * taps * 4)
    flops = float(nv) * nsamp * (4 * taps + (6 if iq else 2))
    return float(nbytes), flops


def bound_s(nbytes: float, flops: float) -> float:
    """The least time (s) the card takes to move ``nbytes`` and do
    ``flops`` float32 operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
