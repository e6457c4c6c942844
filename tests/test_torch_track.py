"""The port's per-period Tracker, TrackState bridge and INI loader against
the JAX package (4.092 Msps, TrackConfig(4, 2, 2) as in test_fast.py)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim
from gnsslib_tpu.constants import (DFRQ1_GLO, FREQ1, FREQ1_GLO, CodeType,
                                   DType)
from gnsslib_tpu.runtime.config import load_ini as jax_load_ini
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch.runtime.config import load_ini
from gnsslib_tpu_torch.track import (TrackConfig, Tracker, state_from_numpy,
                                     state_to_numpy)

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6


def _pair(prns=(7, 8), dtype=DType.REAL, **kw):
    jt = JaxTracker(JaxTrackConfig(4, 2, 2, **kw), list(prns),
                    [CodeType.L1CA] * len(prns), F_SF, F_IF, dtype)
    tt = Tracker(TrackConfig(4, 2, 2, **kw), list(prns),
                 [CodeType.L1CA] * len(prns), F_SF, F_IF, dtype,
                 device="cpu")
    return jt, tt


def _signal(seconds=1.5, dtype=DType.REAL, seed=3):
    rng = np.random.default_rng(5)
    bits = (1 - 2 * rng.integers(0, 2, 512)).astype(np.int8)
    ch = sim.SimChannel(prn=7, doppler=900.0,
                        code_phase=-800 * 1.023e6 / F_SF, carr_phase=0.3,
                        nav_bits=bits)
    noise = sim.noise_std_for_cn0(1.0, 45.0, F_SF, dtype)
    return np.asarray(sim.synthesize([ch], F_SF, F_IF, dtype,
                                     int(seconds * F_SF), noise_std=noise,
                                     seed=seed), np.float32)


@pytest.mark.parametrize("interp", [False, True])
def test_tracker_constants_bit_identical(interp):
    jt, tt = _pair(interp_replica=interp)
    assert set(tt._consts) == set(jt._consts)
    for k, v in jt._consts.items():
        a, b = np.asarray(v), tt._consts[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in ("n_nom", "nwin", "next", "smax", "_tbl_q", "_tbl_m0",
              "_tbl_scale"):
        assert getattr(tt, k) == getattr(jt, k), k
    np.testing.assert_array_equal(tt.offsets, np.asarray(jt.offsets))


def test_state_numpy_round_trip():
    jt, tt = _pair()
    js = jt.start_channels(jt.init_state(), [1], [123], [-456.0])
    js = jt.set_bit_sync(js, 1, 7)
    d = {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}
    ts = state_from_numpy(d, "cpu")
    back = state_to_numpy(ts)
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    # the port's own handoff builds the same state
    ts2 = tt.set_bit_sync(tt.start_channels(tt.init_state(), [1], [123],
                                            [-456.0]), 1, 7)
    for k, v in state_to_numpy(ts2).items():
        np.testing.assert_array_equal(v, d[k], err_msg=k)
    # functional updates: the input state is never written
    assert not bool(ts.active[0]) and int(tt.rebase(ts, 10).loc[1]) == 113
    assert int(ts.loc[1]) == 123


@pytest.mark.parametrize("dtype", [DType.REAL, DType.IQ])
def test_tracker_run_block_matches_jax(dtype):
    """Pull-in from acquisition: ``loc`` exact (both packages round the
    same f32 period lengths), prompts and loop state to f32 summation
    order.  Channel 1 (PRN 8) is inactive with its loc driven negative by
    rebase, so the clamped window path runs too."""
    data = _signal(dtype=dtype)
    jt, tt = _pair(dtype=dtype)
    js = jt.start_channels(jt.rebase(jt.init_state(), 50000), [0], [800],
                           [-900.0])
    ts = state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__},
        "cpu")
    js, jo = jt.run_block(js, jnp.asarray(data), 1200)
    ts, to = tt.run_block(ts, torch.from_numpy(data), 1200)
    np.testing.assert_array_equal(to.loc[:, 0], jo.loc[:, 0])
    np.testing.assert_array_equal(to.n[:, 0], jo.n[:, 0])
    np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)
    scale = np.max(np.abs(jo.ip[:, 0]))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        assert np.max(np.abs(a[:, 0] - b[:, 0])) < 1e-5 * scale
    np.testing.assert_allclose(to.dcarr[:, 0], jo.dcarr[:, 0], atol=0.01)
    np.testing.assert_allclose(to.remcode[:, 0], jo.remcode[:, 0],
                               atol=1e-5)
    jd = {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__}
    for k, v in state_to_numpy(ts).items():
        if v.dtype == np.float32:
            np.testing.assert_allclose(v, jd[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, jd[k], err_msg=k)


# the non-L1CA channel kinds: code type, PRNs (GLONASS: FDMA channel
# numbers), chip rate and nav symbol length (ms); the first PRN is signal,
# the second absent
OTHER = {"G1": (CodeType.G1, [1, -4], 0.511e6, 10.0),
         "SBAS": (CodeType.L1SBAS, [129, 133], 1.023e6, 2.0)}


def other_channels(kind):
    """(ctype, prns, foffsets, f_cfs) of ``kind``'s two channels, as the
    receiver derives them from a config (ChannelConfig.foffset_fdma and
    f_cf)."""
    ctype, prns, _, _ = OTHER[kind]
    g1 = ctype == CodeType.G1
    foffsets = [p * DFRQ1_GLO if g1 else 0.0 for p in prns]
    f_cfs = [FREQ1_GLO + p * DFRQ1_GLO if g1 else FREQ1 for p in prns]
    return ctype, prns, foffsets, f_cfs


def other_pair(kind, dtype, f_sf=F_SF, cfg=(4, 2, 2)):
    """The JAX and the port's Tracker for ``kind``'s channels."""
    ctype, prns, foffsets, f_cfs = other_channels(kind)
    args = (prns, [ctype] * 2, f_sf, F_IF, dtype)
    jt = JaxTracker(JaxTrackConfig(*cfg), *args, foffsets=foffsets,
                    f_cfs=f_cfs)
    tt = Tracker(TrackConfig(*cfg), *args, foffsets=foffsets, f_cfs=f_cfs,
                 device="cpu")
    return jt, tt


def other_signal(kind, dtype, seconds, codei=800, doppler=900.0, seed=3,
                 cn0=45.0, f_sf=F_SF):
    """``kind``'s first channel at ``codei`` samples and ``doppler`` Hz,
    with random nav symbols, in noise at ``cn0`` dB-Hz (f32 samples at
    ``f_sf``)."""
    ctype, prns, foffsets, f_cfs = other_channels(kind)
    _, _, crate, nav_ms = OTHER[kind]
    rng = np.random.default_rng(5)
    bits = (1 - 2 * rng.integers(0, 2, int(seconds * 1000 / nav_ms) + 1)
            ).astype(np.int8)
    ch = sim.SimChannel(prn=prns[0], ctype=ctype, doppler=doppler,
                        code_phase=-codei * crate / f_sf, carr_phase=0.3,
                        nav_bits=bits, nav_ms=nav_ms, f_cf=f_cfs[0],
                        foffset=foffsets[0])
    noise = sim.noise_std_for_cn0(1.0, cn0, f_sf, dtype)
    return np.asarray(sim.synthesize([ch], f_sf, F_IF, dtype,
                                     int(seconds * f_sf), noise_std=noise,
                                     seed=seed), np.float32)


def close_to_jax(a, b, scale):
    """ROADMAP's North-star tolerances on one prompt series: median error
    below 1e-3 of ``scale`` with at most 3 outliers above 5e-3, and a
    correlation above 0.999."""
    d = np.abs(a - b)
    assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
    assert np.median(d) < 1e-3 * scale
    assert np.corrcoef(a, b)[0, 1] > 0.999


@pytest.mark.parametrize("dtype", [DType.REAL, DType.IQ],
                         ids=["real", "iq"])
@pytest.mark.parametrize("kind", ["G1", "SBAS"])
def test_tracker_run_block_other_codes_match_jax(kind, dtype):
    """Pull-in from acquisition for GLONASS G1 (FDMA offsets and carrier
    frequencies per channel, 511-chip code) and SBAS (loop every 2
    periods) channels, real and I/Q: ``loc``, ``n`` and the loop-update
    flags exact, prompts at the North-star tolerances, ``dcarr`` within
    0.5 Hz.  Channel 1 is inactive with its loc driven negative."""
    data = other_signal(kind, dtype, 1.5)
    jt, tt = other_pair(kind, dtype)
    js = jt.start_channels(jt.rebase(jt.init_state(), 50000), [0], [800],
                           [-900.0])
    ts = state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in js.__dataclass_fields__},
        "cpu")
    js, jo = jt.run_block(js, jnp.asarray(data), 1200)
    ts, to = tt.run_block(ts, torch.from_numpy(data), 1200)
    np.testing.assert_array_equal(to.loc[:, 0], jo.loc[:, 0])
    np.testing.assert_array_equal(to.n[:, 0], jo.n[:, 0])
    np.testing.assert_array_equal(to.flagloopfilter, jo.flagloopfilter)
    assert np.any(jo.flagloopfilter[:, 0] > 0)      # the loop updated
    scale = np.max(np.abs(jo.ip[:, 0]))
    for a, b in ((jo.ip, to.ip), (jo.qp, to.qp)):
        close_to_jax(b[:, 0], a[:, 0], scale)
    np.testing.assert_allclose(to.dcarr[:, 0], jo.dcarr[:, 0], atol=0.5)


def test_load_ini_matches_jax(tmp_path):
    fend = tmp_path / "fend.ini"
    fend.write_text("""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      =16.368e6  ; comment
IF1      =4.092e6
DTYPE1   =1
FILE1    =cap.bin
PPMERR   =0.5
[TRACK]
CORRN    =6
CORRD    =3
CORRP    =6
DLLB2    =2.0
PLLB1    =25.0
INTERPREPLICA=1
""")
    ini = tmp_path / "rx.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={fend.name}
RELOCK   =1
PULLINTMO=6.5
[CHANNEL]
NCH      =3
PRN      =1,2,3
SYS      =1,1,1
CTYPE    =1,1,1
FTYPE    =1,1,1
[OUTPUT]
OUTMS    =200
RINEX    =1
RINEXPATH=out
SPP      =1
""")
    j, t = jax_load_ini(str(ini)), load_ini(str(ini))
    jd = dataclasses.asdict(j)
    # the two JAX TrackConfig fields the port fixes at their defaults
    assert jd["track"].pop("resample") == "table"
    assert jd["track"].pop("reset_nco_on_sync") is True
    assert dataclasses.asdict(t) == jd
    assert type(t.track).__module__.startswith("gnsslib_tpu_torch")
