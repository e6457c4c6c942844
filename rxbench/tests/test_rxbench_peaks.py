"""The frozen K1 count at the 13-tap shape, by hand."""
from __future__ import annotations

import pytest

from rxbench import peaks


def test_k1_count_13_taps():
    # 32 channels, 12 tracking, L = 10 periods of 16368 samples, 13 taps
    # 3 samples apart (smax 18): union 10 x 16368 samples of float32, 120
    # replica rows of 16368 + 8 + 36 int8, 320 x 17 bytes of scalars, 320 x
    # 26 float32 sums; 120 x 16368 samples x (4 x 13 + 2) operations
    nbytes, flops = peaks.k1_work(channels=32, active=12, periods=10,
                                  nsamp=16368, taps=13, smax=18)
    assert nbytes == 163680 * 4 + 120 * 16412 + 320 * 17 + 320 * 104
    assert nbytes == 2662880
    assert flops == 106064640.0
    assert peaks.bound_s(nbytes, flops) == pytest.approx(
        106064640.0 / 67e12)
    assert peaks.bound_s(nbytes, flops) == pytest.approx(1.583054e-6,
                                                         rel=1e-6)


def test_k1_count_iq_and_idle():
    nbytes, flops = peaks.k1_work(channels=3, active=2, periods=2,
                                  nsamp=2048, taps=9, smax=4, iq=True)
    assert flops == 4 * 2048 * (4 * 9 + 6)
    assert nbytes == 2 * 2048 * 4 * 2 + 4 * (2048 + 8 + 8) + 6 * 17 \
        + 6 * 2 * 9 * 4
    assert peaks.k1_work(channels=3, active=0, periods=2, nsamp=2048,
                         taps=9, smax=4)[1] == 0.0
