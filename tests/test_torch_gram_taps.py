"""The port's factored-carrier correlator of fetched window rows (K2,
ops/gram_taps.py) against the JAX package's ``FastTracker._taps_fused``
with the Pallas kernel ``gram_usum_impl`` in interpret mode, on the CPU.

The JAX kernel also rounds each 128x128 Gram entry to bf16 before its
diagonal extraction; the port sums in f32, so the bound is test_fast.py's
between correlator backends: median error < 1e-3·scale, at most 3
outliers > 5e-3·scale, correlation > 0.999."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_fast
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.track import FastTracker as JaxFastTracker
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch.ops import gram_taps as gt
from gnsslib_tpu_torch.track import TrackConfig, Tracker

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _rows(iq, B, seed):
    """A JAX FastTracker and masked bf16-exact window rows at its shapes
    (K = 33 rows: the JAX side pads them to 64)."""
    dtype = DType.IQ if iq else DType.REAL
    jtrk = JaxTracker(JaxTrackConfig(4, 2, 2), [7, 8], [CodeType.L1CA] * 2,
                      test_fast.F_SF, test_fast.F_IF, dtype)
    jf = JaxFastTracker(jtrk, use_pallas=False)
    K = jf._fetch_nr - 1
    rng = np.random.default_rng(seed)
    n = rng.integers(jtrk.n_nom - 2, jtrk.n_nom + 3, B)
    keep = np.arange(K * 128).reshape(K, 128)[None] < n[:, None, None]
    wi = rng.integers(-40, 41, (B, K, 128)).astype(np.float32) * keep
    wq = rng.integers(-40, 41, (B, K, 128)).astype(np.float32) * keep
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, jtrk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    return jtrk, jf, wi, (wq if iq else None), rc, rem, ftot


@pytest.mark.parametrize("iq", [False, True])
def test_gram_taps_plain_matches_taps_fused(iq):
    jtrk, jf, wi, wq, rc, rem, ftot = _rows(iq, 20, 3 + iq)
    jw = jnp.asarray(wi, jnp.bfloat16)
    if iq:
        jw = (jw, jnp.asarray(wq, jnp.bfloat16))
    zj = np.asarray(jf._taps_fused(jw, jnp.asarray(rc), jnp.asarray(rem),
                                   jnp.asarray(ftot), interpret=True))
    gt.COUNTS.reset()
    zt = gt.gram_taps(torch.from_numpy(wi).to(torch.bfloat16),
                      None if wq is None else
                      torch.from_numpy(wq).to(torch.bfloat16),
                      torch.from_numpy(rc), torch.from_numpy(rem),
                      torch.from_numpy(ftot), jtrk.offsets, jtrk.smax)
    assert gt.COUNTS.plain == 1 and gt.COUNTS.kernel == 0
    zt = zt.numpy()
    assert zt.shape == zj.shape
    d = np.abs(zt - zj)
    scale = np.max(np.abs(zj))
    assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
    assert np.median(d) < 1e-3 * scale
    assert np.corrcoef(zt.ravel(), zj.ravel())[0, 1] > 0.999


def test_gram_taps_takes_wide_tap_geometry():
    """The JAX split-Gram layout needs 2*smax <= 64; the port's K2 has no
    such layout: a 25-tap, smax=36 geometry gives the direct tap sums."""
    trk = Tracker(TrackConfig(12, 3, 6), [7], [CodeType.L1CA],
                  test_fast.F_SF, test_fast.F_IF, DType.REAL, device="cpu")
    assert 2 * trk.smax > 64
    rng = np.random.default_rng(5)
    B, K = 3, (trk.nwin + 127) // 128
    wi = torch.from_numpy(rng.integers(-8, 9, (B, K, 128)).astype(
        np.float32)).to(torch.bfloat16)
    rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                     (B, trk.next)))
    zero = torch.zeros(B)
    z = gt.gram_taps(wi, None, rc, zero, zero, trk.offsets, trk.smax)
    # rem = ftot = 0: no mixing, so cos taps are plain shifted dot products
    x = wi.float().reshape(B, -1)
    pad = torch.zeros((B, K * 128 + 2 * trk.smax))
    pad[:, :trk.next] = rc.float()
    for t, o in enumerate(trk.offsets):
        ref = (x * pad[:, trk.smax + o:trk.smax + o + K * 128]).sum(1)
        assert torch.equal(z[:, 2 * t], ref)
        assert torch.all(z[:, 2 * t + 1] == 0)


def test_gram_taps_checks_inputs():
    jtrk, _, wi, _, rc, rem, ftot = _rows(False, 4, 1)
    args = [torch.from_numpy(wi).to(torch.bfloat16), None,
            torch.from_numpy(rc), torch.from_numpy(rem),
            torch.from_numpy(ftot)]
    off, smax = jtrk.offsets, jtrk.smax
    with pytest.raises(TypeError, match="win_i must be torch.bfloat16"):
        gt.gram_taps(args[0].float(), *args[1:], off, smax)
    with pytest.raises(ValueError, match="win_q shape"):
        gt.gram_taps(args[0], args[0][:2].contiguous(), *args[2:], off, smax)
    with pytest.raises(ValueError, match=r"win_i must be \(B, K, 128\)"):
        gt.gram_taps(args[0][..., :64].contiguous(), *args[1:], off, smax)
    with pytest.raises(ValueError, match="smax"):
        gt.gram_taps(*args, [0, smax + 1, -smax - 1], smax)
