"""The port's fetched-window correlators (K3-K5, ops/window_taps.py) and
its window fetch against the JAX package: the plain versions against the
Pallas kernels of gnsslib_tpu/ops/pallas_corr.py in interpret mode, and
FastTracker._fetch_windows against the JAX one, on the CPU.

Both sides compute the same f32 arithmetic (K3: the same bf16 rounding of
the mixed samples), so the bound is f32 summation order and cos/sin ulps:
1e-5 of each window's L1 norm sum |x_i| (|replica| = 1)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_fast
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.ops import pallas_corr
from gnsslib_tpu.track import FastTracker as JaxFastTracker
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch.ops import window_taps as wt
from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = test_fast.F_SF
F_IF = test_fast.F_IF


def _trackers(iq, prns=(7, 8)):
    dtype = DType.IQ if iq else DType.REAL
    jtrk = JaxTracker(JaxTrackConfig(4, 2, 2), list(prns),
                      [CodeType.L1CA] * len(prns), F_SF, F_IF, dtype)
    ttrk = Tracker(TrackConfig(4, 2, 2), list(prns),
                   [CodeType.L1CA] * len(prns), F_SF, F_IF, dtype,
                   device="cpu")
    return jtrk, ttrk


def _inputs(trk, B, iq, seed):
    rng = np.random.default_rng(seed)
    shape = (B, trk.nwin, 2) if iq else (B, trk.nwin)
    win = rng.integers(-40, 41, shape).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, trk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    n = rng.integers(trk.n_nom - 2, trk.nwin + 1, B).astype(np.int32)
    a = np.abs(win).reshape(B, trk.nwin, -1).sum(-1)
    l1 = max(float(a[b, :k].sum()) for b, k in enumerate(n))
    return win, rc, rem, ftot, n, l1


def _jax(name, win, rc, rem, ftot, n, offsets, smax):
    if name == "correlate_windows":
        return pallas_corr.correlate_windows(
            win, rc, rem, ftot, n, offsets=offsets, smax=smax,
            interpret=True)
    impl = {"correlate_windows8": pallas_corr.correlate_windows8_impl,
            "correlate_windows16": pallas_corr.correlate_windows16_impl}
    return impl[name](win, rc, rem, ftot, n, offsets, smax, interpret=True)


@pytest.mark.parametrize("name,iq", [
    (f, iq) for f in ("correlate_windows", "correlate_windows8",
                      "correlate_windows16") for iq in (False, True)])
def test_window_taps_plain_matches_pallas_interpret(name, iq):
    """K5/K4/K3: the wrapper's plain version on the CPU against its Pallas
    function on the same windows (16 windows: K3's 16-window cells)."""
    jtrk, ttrk = _trackers(iq)
    win, rc, rem, ftot, n, l1 = _inputs(ttrk, 16, iq, 3 + iq)
    bf16 = name == "correlate_windows16"
    jw = jnp.asarray(win).astype(jnp.bfloat16 if bf16 else jnp.float32)
    jrc = jnp.asarray(rc if bf16 else rc.astype(np.float32))
    offsets = tuple(int(o) for o in jtrk.offsets)
    zj = np.asarray(_jax(name, jw, jrc, jnp.asarray(rem), jnp.asarray(ftot),
                         jnp.asarray(n), offsets, jtrk.smax))
    tw = torch.from_numpy(win)
    trc = torch.from_numpy(rc)
    if bf16:
        tw = tw.to(torch.bfloat16)
    else:
        trc = trc.to(torch.float32)
    counts = {"correlate_windows": wt.COUNTS5,
              "correlate_windows8": wt.COUNTS8,
              "correlate_windows16": wt.COUNTS16}[name]
    counts.reset()
    zt = getattr(wt, name)(tw, trc, torch.from_numpy(rem),
                           torch.from_numpy(ftot), torch.from_numpy(n),
                           ttrk.offsets, ttrk.smax)
    assert counts.plain == 1 and counts.kernel == 0
    assert zt.shape == (16, 2 * len(offsets))
    assert float(np.abs(zt.numpy() - zj).max()) <= 1e-5 * l1


def test_window_taps_wrappers_check_inputs():
    _, ttrk = _trackers(False)
    win, rc, rem, ftot, n, _ = _inputs(ttrk, 4, False, 1)
    args = [torch.from_numpy(a) for a in (win, rc.astype(np.float32), rem,
                                          ftot, n)]
    off, smax = ttrk.offsets, ttrk.smax
    with pytest.raises(TypeError, match="windows must be torch.bfloat16"):
        wt.correlate_windows16(*args, off, smax)
    with pytest.raises(TypeError, match="rc must be torch.float32"):
        wt.correlate_windows(args[0], torch.from_numpy(rc), *args[2:], off,
                             smax)
    with pytest.raises(ValueError, match="next >= nwin"):
        wt.correlate_windows8(args[0], args[1][:, :-1].contiguous(),
                              *args[2:], off, smax)
    with pytest.raises(ValueError, match="n shape"):
        wt.correlate_windows8(*args[:4], args[4][:3], off, smax)
    with pytest.raises(ValueError, match="odd tap count"):
        wt.correlate_windows(*args, off[:2], smax)
    with pytest.raises(ValueError, match="contiguous"):
        wt.correlate_windows(args[0].t().contiguous().t(), *args[1:], off,
                             smax)


@pytest.mark.parametrize("iq", [False, True])
def test_fetch_windows_matches_jax(iq):
    """The port's plain-indexing window fetch against the JAX row take +
    one-hot rotation: exact on the 8-bit alphabet, flat and in row form
    with the valid-length mask.  Windows that leave the block (a
    far-negative inactive start, one running past the end) hold NaN rows
    from the JAX fetch; the port's clamped fetch stays finite and agrees
    wherever the JAX one is finite."""
    jtrk, ttrk = _trackers(iq)
    jf = JaxFastTracker(jtrk, use_pallas=False)
    tf = FastTracker(ttrk)
    rng = np.random.default_rng(11 + iq)
    nblock = 12 * ttrk.n_nom + 50
    block = rng.integers(-128, 128, (nblock, 2) if iq else nblock
                         ).astype(np.float32)
    inside = rng.integers(0, 10 * ttrk.n_nom, 9)
    wstart = np.concatenate([inside, [-40 * ttrk.n_nom, nblock - 3000]]
                            ).astype(np.int32)
    n = rng.integers(ttrk.n_nom - 2, ttrk.n_nom + 3, len(wstart)
                     ).astype(np.int32)
    jb2 = jf._block_rows(jnp.asarray(block))
    tb2 = tf._block_rows(torch.from_numpy(block))
    jw = np.asarray(jf._fetch_windows(jb2, jnp.asarray(wstart)
                                      ).astype(jnp.float32))
    tw = tf._fetch_windows(tb2, torch.from_numpy(wstart))
    assert tw.dtype == torch.bfloat16
    tw = tw.float().numpy()
    k = len(inside)
    np.testing.assert_array_equal(tw[:k], jw[:k])
    fin = np.isfinite(jw)
    assert not np.all(fin[k:], axis=tuple(range(1, jw.ndim))).any()
    assert np.all(np.isfinite(tw)) and np.array_equal(tw[fin], jw[fin])

    jr = jf._fetch_windows(jb2, jnp.asarray(wstart), rowform=True,
                           nvalid=jnp.asarray(n))
    tr = tf._fetch_windows(tb2, torch.from_numpy(wstart), rowform=True,
                           nvalid=torch.from_numpy(n))
    jr, tr = (jr, tr) if iq else ((jr,), (tr,))
    for a, b in zip(jr, tr):
        a = np.asarray(a.astype(jnp.float32))
        b = b.float().numpy()
        assert b.shape == a.shape
        np.testing.assert_array_equal(b[:k], a[:k])
        assert np.all(np.isfinite(b))
