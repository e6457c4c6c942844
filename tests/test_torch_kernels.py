"""The helpers the port's kernel wrappers share (ops/kernels.py), on the
CPU: the tap-offset progression test that routes offsets to the cluster
kernels (K1, K3-K5) or their v1 kernels, and the window wrappers'
counters."""
import numpy as np
import pytest
import torch

from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.ops import kernels
from gnsslib_tpu_torch.ops import window_taps as wt
from gnsslib_tpu_torch.ops.correlator import tap_offsets


@pytest.mark.parametrize("offsets,d", [
    ((0,), 1),
    ((0, -1, 1), 1),
    ((0, -3, 3, -6, 6), 3),
    (tuple(int(o) for o in tap_offsets(6, 3)), 3),
    (tuple(int(o) for o in tap_offsets(12, 4)), 4),
    (tuple(int(o) for o in tap_offsets(1, 7)), 7),
    ((0, -1, 2), None),           # not symmetric
    ((0, 3, -3), None),           # late tap before early
    ((3,), None),                 # one tap off the prompt
    ((0, -2, 2, -4, 5), None),    # uneven spacing
    ((0, 1, -1), None),           # negative step
    ((0, 0, 0), None),            # zero step
    ((0, -2, 2, -6, 6), None),    # a gap
])
def test_progression(offsets, d):
    """The step d of tap_offsets(corrn, d) offsets, None for any others;
    K1's wrapper and the window wrappers route by the one copy."""
    assert kernels.progression(offsets) == d
    assert bt.progression is kernels.progression
    assert wt.progression is kernels.progression


@pytest.mark.parametrize("name", ["correlate_windows", "correlate_windows8",
                                  "correlate_windows16"])
def test_window_counts_on_cpu(name):
    """Each window wrapper has its own kernel, v1 and plain counters in
    the registry; CPU tensors take the plain version and launch nothing."""
    counts = kernels.REGISTRY[name]
    counts.reset()
    assert counts.values() == {"kernel": 0, "plain": 0, "v1": 0}
    rng = np.random.default_rng(3)
    B, nwin, smax = 3, 64, 4
    bf16 = name == "correlate_windows16"
    win = torch.from_numpy(rng.integers(-8, 9, (B, nwin)).astype(np.float32))
    rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                     (B, nwin + 2 * smax)))
    win = win.to(torch.bfloat16) if bf16 else win
    rc = rc if bf16 else rc.to(torch.float32)
    rem = torch.zeros(B)
    ftot = torch.full((B,), 0.25)
    n = torch.full((B,), nwin, dtype=torch.int32)
    for offsets in ((0, -2, 2), (0, -1, 2)):     # progression or not
        z = getattr(wt, name)(win, rc, rem, ftot, n, offsets, smax)
        assert z.shape == (B, 6)
    assert counts.values() == {"kernel": 0, "plain": 2, "v1": 0}


def test_gram_counts_on_cpu():
    """K2's wrapper has its own kernel, v1 and plain counters in the
    registry; CPU tensors take the plain version and launch nothing, for
    geometries of either kernel (tile_plan or None)."""
    from gnsslib_tpu_torch.ops import gram_taps as gt
    counts = kernels.REGISTRY["gram_taps"]
    assert counts is gt.COUNTS
    counts.reset()
    assert counts.values() == {"kernel": 0, "plain": 0, "v1": 0}
    rng = np.random.default_rng(4)
    B, K = 2, 3
    win = torch.from_numpy(rng.integers(-8, 9, (B, K, 128)).astype(
        np.float32)).to(torch.bfloat16)
    rem = torch.zeros(B)
    ftot = torch.full((B,), 0.25)
    for smax, offsets in ((2, (0, -2, 2)), (40, (0, -40, 40))):
        assert (gt.tile_plan(K, smax) is None) == (smax > gt.MAX_SMAX)
        rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                         (B, K * 128 + 2 * smax)))
        z = gt.gram_taps(win, None, rc, rem, ftot, offsets, smax)
        assert z.shape == (B, 6)
    assert counts.values() == {"kernel": 0, "plain": 2, "v1": 0}
