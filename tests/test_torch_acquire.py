"""The port's Acquirer against the JAX Acquirer on synthesized signals.

``acquired``, ``codei`` and ``freqi`` must be exact (the same argmax over
the same power surface); ``cn0`` within 1e-3 dB and ``peakr`` within
1e-4 relative — the surfaces differ only by FFT and cumsum round-off
(complex64), ~1e-6 relative."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim
from gnsslib_tpu.acquire import Acquirer as JaxAcquirer
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu_torch.acquire import Acquirer

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

# (f_sf, f_if): the exact full-rate search at 4.092 Msps and the coarse
# (cumsum rebin) + refine search of the 16.368 Msps envelope
CASES = [(4.092e6, 1.023e6), (16.368e6, 4.092e6)]
PRNS = [2, 5, 9, 17]                    # 5 is absent


def _data(f_sf, f_if, dtype=DType.REAL):
    nsamp = int(f_sf / 1000)
    truth = {2: (3000.0, int(0.15 * nsamp)), 9: (-1800.0, int(0.7 * nsamp)),
             17: (650.0, nsamp - 3)}
    chans = [sim.SimChannel(prn=p, doppler=d, code_phase=-o * 1.023e6 / f_sf,
                            carr_phase=0.37 * p) for p, (d, o) in
             truth.items()]
    x = sim.synthesize(chans, f_sf, f_if, dtype, 13 * nsamp,
                       noise_std=sim.noise_std_for_cn0(1.0, 44.0, f_sf,
                                                       dtype), seed=42)
    return np.asarray(x, np.float32), truth, nsamp


def _same(rj, rt):
    np.testing.assert_array_equal(rt.acquired, rj.acquired)
    np.testing.assert_array_equal(rt.codei, rj.codei)
    np.testing.assert_array_equal(rt.freqi, rj.freqi)
    np.testing.assert_array_equal(rt.confirmed, rj.confirmed)
    np.testing.assert_allclose(rt.cn0, rj.cn0, atol=1e-3)
    np.testing.assert_allclose(rt.peakr, rj.peakr, rtol=1e-4)
    np.testing.assert_array_equal(rt.dcarr, rj.dcarr)


@pytest.mark.parametrize("f_sf,f_if", CASES)
def test_search_matches_jax(f_sf, f_if):
    data, truth, nsamp = _data(f_sf, f_if)
    ja = JaxAcquirer(PRNS, [CodeType.L1CA] * 4, f_sf, f_if, DType.REAL)
    ta = Acquirer(PRNS, [CodeType.L1CA] * 4, f_sf, f_if, DType.REAL,
                  device="cpu")
    assert (ta.coarse, ta.nfft, ta.nsamp_d) == (ja.coarse, ja.nfft,
                                                ja.nsamp_d)
    assert ta.coarse == (f_sf > 5e6)
    rj, rt = ja.search(data), ta.search(data)
    _same(rj, rt)
    assert list(rt.acquired) == [p in truth for p in PRNS]
    for i, p in enumerate(PRNS):
        if p in truth:
            assert abs(rt.dcarr[i] + truth[p][0]) <= 100.0 + 1e-6
            derr = abs(int(rt.codei[i]) - truth[p][1])
            assert min(derr, nsamp - derr) <= 1


@pytest.mark.parametrize("f_sf,f_if", CASES)
def test_search_dev_subset_matches_jax(f_sf, f_if):
    """Device-block search over a pending subset (3 of 8 channels, padded
    to a bucket of 4)."""
    data, truth, _ = _data(f_sf, f_if)
    prns = PRNS + [11, 20, 25, 31]
    ja = JaxAcquirer(prns, [CodeType.L1CA] * 8, f_sf, f_if, DType.REAL)
    ta = Acquirer(prns, [CodeType.L1CA] * 8, f_sf, f_if, DType.REAL,
                  device="cpu")
    idx = [1, 2, 3]
    rj = ja.search_dev_collect(ja.search_dev_start(jnp.asarray(data),
                                                   idx=idx))
    rt = ta.search_dev_collect(ta.search_dev_start(torch.from_numpy(data),
                                                   idx=idx))
    _same(rj, rt)
    assert not rt.acquired[0]               # outside the subset


def test_search_iq_matches_jax():
    f_sf, f_if = 2.048e6, 0.0
    data, truth, _ = _data(f_sf, f_if, DType.IQ)
    ja = JaxAcquirer(PRNS, [CodeType.L1CA] * 4, f_sf, f_if, DType.IQ)
    ta = Acquirer(PRNS, [CodeType.L1CA] * 4, f_sf, f_if, DType.IQ,
                  device="cpu")
    _same(ja.search(data), ta.search(data))


@pytest.mark.parametrize("kind", ["G1", "SBAS"])
def test_search_other_codes_match_jax(kind):
    """GLONASS G1 (511-chip code, FDMA offsets) and SBAS channels: the
    same decisions, code phases and Doppler bins as the JAX Acquirer; the
    present channel is found at its code phase and Doppler."""
    from test_torch_track import F_SF, F_IF, other_channels, other_signal
    ctype, prns, foffsets, _ = other_channels(kind)
    data = other_signal(kind, DType.REAL, 0.013, codei=1234, doppler=-1800.0,
                        cn0=44.0)
    args = (prns, [ctype] * 2, F_SF, F_IF, DType.REAL)
    ja = JaxAcquirer(*args, foffsets=foffsets)
    ta = Acquirer(*args, foffsets=foffsets, device="cpu")
    rj, rt = ja.search(data), ta.search(data)
    _same(rj, rt)
    assert list(rt.acquired) == [True, False]
    assert abs(rt.dcarr[0] - 1800.0) <= 100.0 + 1e-6
    nsamp = int(F_SF / 1000)
    derr = abs(int(rt.codei[0]) - 1234)
    assert min(derr, nsamp - derr) <= 1
