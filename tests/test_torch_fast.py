"""The port's band correlator and steady-state FastTracker against the
JAX package's band-resident Pallas kernel (interpret mode on the CPU), and
the FastTracker's other correlator backends against their JAX
counterparts.

Tolerances are test_fast.py's between correlator backends: ip/qp median
error < 1e-3·scale with at most 3 outliers > 5e-3·scale, correlation >
0.999, dcarr within 0.5 Hz, loc exact.  The JAX kernel rounds the mixed
samples and its Gram matrix to bf16; the port sums in f32, so the bound
is set by the JAX side's bf16 rounding (~2e-3 relative per term)."""
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
from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                     state_from_numpy)

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = test_fast.F_SF
F_IF = test_fast.F_IF


def _close(a, b, scale):
    d = np.abs(a - b)
    assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
    assert np.median(d) < 1e-3 * scale


def _ports(jtrk, prns):
    tt = Tracker(TrackConfig(4, 2, 2), prns, [CodeType.L1CA] * len(prns),
                 F_SF, F_IF, jtrk.dtype, device="cpu")
    return tt, FastTracker(tt)


def _np_state(js):
    return {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}


@pytest.fixture(scope="module")
def locked():
    return test_fast._locked_state()


def _band_inputs(jtrk, B, iq, seed):
    rng = np.random.default_rng(seed)
    n_nom, nxt = jtrk.n_nom, jtrk.next
    nblock = 40 * n_nom
    shape = (nblock, 2) if iq else (nblock,)
    block = rng.integers(-40, 41, shape).astype(np.float32)
    wstart = rng.integers(3000, 3000 + 9 * n_nom, B).astype(np.int32)
    n = rng.integers(n_nom - 2, n_nom + 3, B).astype(np.int32)
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, nxt))
    act = rng.uniform(size=B) < 0.8
    return block, wstart, n, rem, ftot, rc, act


@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_plain_matches_pallas_interpret(iq):
    """band_taps_plain against FastTracker._taps_band(interpret=True) —
    the Pallas band kernel on the same windows (active ones; the JAX
    kernel computes clamped garbage for inactive windows, the port
    zeros)."""
    dtype = DType.IQ if iq else DType.REAL
    jtrk = JaxTracker(JaxTrackConfig(4, 2, 2), [7, 8], [CodeType.L1CA] * 2,
                      F_SF, F_IF, dtype)
    jf = JaxFastTracker(jtrk, use_pallas=False)
    B = 40
    block, wstart, n, rem, ftot, rc, act = _band_inputs(jtrk, B, iq, 11)
    zj, okj = jf._taps_band(jf._block_rows(jnp.asarray(block)),
                            jnp.asarray(wstart), jnp.asarray(rc),
                            jnp.asarray(rem), jnp.asarray(ftot),
                            jnp.asarray(n), jnp.asarray(act),
                            interpret=True)
    offsets = jtrk.offsets
    zt, okt = bt.band_taps_plain(
        torch.from_numpy(block), torch.from_numpy(rc),
        torch.from_numpy(wstart), torch.from_numpy(n),
        torch.from_numpy(rem), torch.from_numpy(ftot),
        torch.from_numpy(act), offsets, jtrk.smax)
    assert bool(okj) and bool(okt)
    zj, zt = np.asarray(zj)[act], zt.numpy()[act]
    scale = np.max(np.abs(zj))
    _close(zt, zj, scale)
    assert np.corrcoef(zt.ravel(), zj.ravel())[0, 1] > 0.999
    z_off, ok_off = bt.band_taps_plain(
        torch.from_numpy(block), torch.from_numpy(rc),
        torch.from_numpy(wstart), torch.from_numpy(n),
        torch.from_numpy(rem), torch.from_numpy(ftot),
        torch.zeros(B, dtype=torch.bool), offsets, jtrk.smax)
    assert bool(ok_off) and torch.all(z_off == 0)


def test_band_taps_wrapper_cpu_and_checks():
    """On CPU tensors the wrapper is the plain version (and counts it);
    a wrong dtype, tap count or stride raises; an out-of-block active
    window clears ``ok`` and gives zeros."""
    jtrk = JaxTracker(JaxTrackConfig(4, 2, 2), [7], [CodeType.L1CA],
                      F_SF, F_IF, DType.REAL)
    block, wstart, n, rem, ftot, rc, act = _band_inputs(jtrk, 8, False, 3)
    args = [torch.from_numpy(a) for a in (block, rc, wstart, n, rem, ftot,
                                          act)]
    offsets = jtrk.offsets
    bt.COUNTS.reset()
    z, ok = bt.band_taps(*args, offsets, jtrk.smax)
    z0, _ = bt.band_taps_plain(*args, offsets, jtrk.smax)
    assert bt.COUNTS.plain == 1 and bt.COUNTS.kernel == 0
    assert torch.equal(z, z0) and bool(ok)
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(TypeError, match="wstart"):
        bt.band_taps(*bad, offsets, jtrk.smax)
    with pytest.raises(ValueError, match="odd tap count"):
        bt.band_taps(*args, offsets[:4], jtrk.smax)
    with pytest.raises(ValueError, match="smax"):
        bt.band_taps(*args, [0, -jtrk.smax - 1, jtrk.smax + 1], jtrk.smax)
    strided = list(args)
    strided[1] = args[1].t().contiguous().t()       # same shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        bt.band_taps(*strided, offsets, jtrk.smax)
    far = list(args)
    far[2] = far[2].clone()
    far[2][0] = block.shape[0] - 10
    far[6] = torch.ones_like(far[6])
    z, ok = bt.band_taps(*far, offsets, jtrk.smax)
    assert not bool(ok) and torch.all(z[0] == 0)


def test_fast_run_block_matches_jax_band(locked):
    """600 steady-state steps from test_fast's locked state: the port's
    FastTracker (plain band correlator on the CPU) against the JAX
    FastTracker with the Pallas band kernel in interpret mode."""
    jtrk, js, jblock = locked
    jf = JaxFastTracker(jtrk, use_pallas=False)
    jf.corr = "band-interpret"
    _, jo = jf.run_block(js, jblock, 600)
    _, tf = _ports(jtrk, [7])
    ts = state_from_numpy(_np_state(js), "cpu")
    _, to = tf.run_block(ts, torch.from_numpy(np.array(jblock)), 600)
    np.testing.assert_array_equal(to.loc, jo.loc)
    scale = np.max(np.abs(jo.ip))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        _close(b, a, scale)
        assert np.corrcoef(a[:, 0], b[:, 0])[0, 1] > 0.999
    np.testing.assert_allclose(to.dcarr, jo.dcarr, atol=0.5)
    np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)
    np.testing.assert_array_equal(to.n, jo.n)


# port backend -> how the JAX FastTracker runs its counterpart on the CPU
JAX_BACKEND = {"pallas": {"use_pallas": "interpret"},
               "fused": {"use_pallas": False, "corr": "fused-interpret"},
               "xla": {"use_pallas": False}}


def _jax_fast(jtrk, corr):
    kw = dict(JAX_BACKEND[corr])
    name = kw.pop("corr", None)
    jf = JaxFastTracker(jtrk, **kw)
    if name:
        jf.corr = name
    return jf


@pytest.mark.parametrize("corr", ["pallas", "fused", "xla"])
def test_fast_backend_matches_jax(locked, corr):
    """600 steady-state steps from test_fast's locked state through the
    port's fetch backends (plain K3, plain K2, the eager einsum
    formulation) against the JAX FastTracker with the same backend (Pallas
    kernels in interpret mode), at test_fast.py's inter-backend
    tolerances."""
    jtrk, js, jblock = locked
    _, jo = _jax_fast(jtrk, corr).run_block(js, jblock, 600)
    _, tf = _ports(jtrk, [7])
    tf.corr = corr
    _, to = tf.run_block(state_from_numpy(_np_state(js), "cpu"),
                         torch.from_numpy(np.array(jblock)), 600)
    np.testing.assert_array_equal(to.loc, jo.loc)
    scale = np.max(np.abs(jo.ip))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        _close(b, a, scale)
        assert np.corrcoef(a[:, 0], b[:, 0])[0, 1] > 0.999
    np.testing.assert_allclose(to.dcarr, jo.dcarr, atol=0.5)
    np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)


def test_fast_corr_choice(locked):
    """use_pallas keeps the JAX meaning; corr takes the ported backends,
    refuses unknown names and says the diag formulations are unported."""
    jtrk, _, _ = locked
    tt, _ = _ports(jtrk, [7])
    assert FastTracker(tt).corr == "band"
    assert FastTracker(tt, use_pallas=True).corr == "pallas"
    assert FastTracker(tt, use_pallas=False).corr == "xla"
    f = FastTracker(tt)
    for corr in ("band", "pallas", "fused", "xla"):
        f.corr = corr
        assert f.corr == corr
    with pytest.raises(ValueError, match="expected one of"):
        f.corr = "band-interpret"
    for corr in ("diag", "diag2"):
        with pytest.raises(NotImplementedError, match="not ported"):
            f.corr = corr
    assert f.corr == "xla"


@pytest.mark.parametrize("corr", ["pallas", "fused", "xla"])
def test_fast_fetch_backends_tolerate_inactive_channels(locked, corr):
    """A far-negative inactive start is clamped by the window fetch (no
    device fault, no out-of-block flag) and leaves the active channel as
    the band backend tracks it; an ACTIVE window past the block end still
    raises at collect."""
    jtrk, _, jblock = locked
    tt, tf = _ports(jtrk, [7, 8])
    st = tt.rebase(tt.init_state(), 40 * tt.n_nom)
    st = tt.start_channels(st, [0], [800], [-900.0])
    st = tt.set_bit_sync(st, 0, 0)
    block = torch.from_numpy(np.array(jblock))
    _, ob = tf.run_block(st, block, 100)
    tf.corr = corr
    _, of = tf.run_block(st, block, 100)
    np.testing.assert_array_equal(of.loc[:, 0], ob.loc[:, 0])
    scale = np.max(np.abs(ob.ip[:, 0]))
    assert np.median(np.abs(ob.ip[:, 0] - of.ip[:, 0])) < 1e-3 * scale
    far = tt.start_channels(st, [1], [block.shape[0] - tt.n_nom], [-900.0])
    far = tt.set_bit_sync(far, 1, 0)
    _, handle = tf.run_block_start(far, block, 20)
    with pytest.raises(RuntimeError, match="outside the sample block"):
        tf.run_block_collect(handle)


def test_fast_out_of_block_window_raises(locked):
    """An active window that runs past the block (channel spread beyond
    what the block holds) is flagged and raised at collect."""
    jtrk, _, jblock = locked
    tt, tf = _ports(jtrk, [7, 8])
    st = tt.start_channels(tt.init_state(), [0, 1],
                           [800, jblock.shape[0] - tt.n_nom], [-900.0] * 2)
    for c in range(2):
        st = tt.set_bit_sync(st, c, 0)
    _, handle = tf.run_block_start(st, torch.from_numpy(np.array(jblock)),
                                   20)
    with pytest.raises(RuntimeError, match="outside the sample block"):
        tf.run_block_collect(handle)


def test_fast_tolerates_inactive_channels(locked):
    """An unlocked channel's loc runs far negative under rebase; its
    windows must neither raise nor disturb the active channel, matching
    the JAX band backend on channel 0 (test_fast.py's inactive case)."""
    jtrk, _, jblock = locked
    jtrk2 = JaxTracker(JaxTrackConfig(4, 2, 2), [7, 8],
                       [CodeType.L1CA] * 2, F_SF, F_IF, DType.REAL)
    js = jtrk2.rebase(jtrk2.init_state(), 40 * jtrk2.n_nom)
    js = jtrk2.start_channels(js, [0], [800], [-900.0])
    js = jtrk2.set_bit_sync(js, 0, 0)
    jf = JaxFastTracker(jtrk2, use_pallas=False)
    jf.corr = "band-interpret"
    _, jo = jf.run_block(js, jblock, 100)
    _, tf = _ports(jtrk2, [7, 8])
    _, to = tf.run_block(state_from_numpy(_np_state(js), "cpu"),
                         torch.from_numpy(np.array(jblock)), 100)
    np.testing.assert_array_equal(to.loc[:, 0], jo.loc[:, 0])
    scale = np.max(np.abs(jo.ip[:, 0])) or 1.0
    assert np.median(np.abs(jo.ip[:, 0] - to.ip[:, 0])) < 1e-3 * scale


def test_fast_requires_multiple_of_loop(locked):
    jtrk, js, jblock = locked
    _, tf = _ports(jtrk, [7])
    with pytest.raises(ValueError, match="multiple of L"):
        tf.run_block(tf.trk.init_state(), torch.zeros(100000), 1001)


@pytest.mark.parametrize("kind,dtype,f_sf,steps", [
    ("G1", DType.IQ, 4.092e6, 600), ("SBAS", DType.REAL, 4.096e6, 120)],
    ids=["G1-iq", "SBAS-real"])
def test_fast_band_other_codes_match_jax(kind, dtype, f_sf, steps):
    """The steady state of the multi-GNSS receiver's other groups: a G1
    channel on I/Q samples (FDMA offset, 511-chip code, L = 10) and an SBAS
    channel (L = 2, super-steps of 2 periods), after 1.5 s of JAX pull-in
    and bit sync, through the port's FastTracker (plain band correlator)
    and the JAX FastTracker with the Pallas band kernel in interpret mode:
    ``loc`` exact, prompts at the North-star tolerances, ``dcarr`` within
    0.5 Hz.  Both run 60 loop updates, as the L1CA case does: the loop is
    closed, and the two correlators' last-bit differences (bf16 on the
    JAX side) grow with the updates, as between the JAX package's own
    backends (ROADMAP, chaotic divergence), so the comparison stops before
    they can.  SBAS runs at 4.096 Msps: at 4.092 Msps its 1.023 Mchip/s
    code is chip-commensurate (4 samples a chip); G1 is not (8.008)."""
    from test_torch_track import close_to_jax, other_pair, other_signal
    data = other_signal(kind, dtype, 2.3, f_sf=f_sf)
    jt, tt = other_pair(kind, dtype, f_sf=f_sf)
    js = jt.start_channels(jt.init_state(), [0], [800], [-900.0])
    js, _ = jt.run_block(js, jnp.asarray(data), 1500)
    js = jt.set_bit_sync(js, 0, 0)
    jblock = jnp.asarray(data[1500 * jt.n_nom:])
    js = jt.rebase(js, 1500 * jt.n_nom)
    jf = JaxFastTracker(jt, use_pallas=False)
    jf.corr = "band-interpret"
    assert jf.L == (2 if kind == "SBAS" else 10)
    _, jo = jf.run_block(js, jblock, steps)
    tf = FastTracker(tt)
    _, to = tf.run_block(state_from_numpy(_np_state(js), "cpu"),
                         torch.from_numpy(np.array(jblock)), steps)
    # channel 0 (channel 1, never started, computes nothing either side
    # reads)
    np.testing.assert_array_equal(to.loc[:, 0], jo.loc[:, 0])
    np.testing.assert_array_equal(to.flagloopfilter[:, 0],
                                  jo.flagloopfilter[:, 0])
    scale = np.max(np.abs(jo.ip[:, 0]))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        close_to_jax(b[:, 0], a[:, 0], scale)
    np.testing.assert_allclose(to.dcarr[:, 0], jo.dcarr[:, 0], atol=0.5)
