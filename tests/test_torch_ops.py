"""Port ops (gnsslib_tpu_torch.ops) against the JAX package's ops on the
same seeded numpy inputs.

Tolerances: the table builders run the same float64 numpy code, so they
must be bit-identical.  Element-wise float32 math (phase ramps, NCO
advances) may differ by the last bit where XLA fuses a multiply-add, so
it is held to 2 ulp-scale absolute bounds; integer results (period
lengths, chip indices, argmax) are exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gnsslib_tpu.ops import carrier as jcarrier
from gnsslib_tpu.ops import correlator as jcorr
from gnsslib_tpu.ops import fftcorr as jfft
from gnsslib_tpu.ops import nco as jnco
from gnsslib_tpu.ops import resample as jres
from gnsslib_tpu.ops import stats as jstats
from gnsslib_tpu_torch.ops import carrier, correlator, fftcorr, nco
from gnsslib_tpu_torch.ops import resample, stats

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
TI = 1.0 / F_SF
NNOM = 4092
CPU = torch.device("cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def tables():
    jc = jnco.CarrierTables.build(1.023e6 + 37.0, TI, NNOM + 8, NNOM)
    tc = nco.CarrierTables.build(1.023e6 + 37.0, TI, NNOM + 8, NNOM, CPU)
    jk = jnco.CodeTables.build(1.023e6, TI, NNOM + 30, NNOM, 1023)
    tk = nco.CodeTables.build(1.023e6, TI, NNOM + 30, NNOM, 1023, CPU)
    return jc, tc, jk, tk


def test_nco_tables_bit_identical():
    jc, tc, jk, tk = tables()
    for a, b in ((jc.base_phase, tc.base_phase),
                 (jc.adv_cycles, tc.adv_cycles), (jk.chip_int, tk.chip_int),
                 (jk.chip_frac, tk.chip_frac), (jk.adv_chips, tk.adv_chips)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_nco_advances_and_period():
    jc, tc, jk, tk = tables()
    rng = np.random.default_rng(0)
    rem = rng.uniform(0, 1, 64).astype(np.float32)
    remc = rng.uniform(-0.12, 0.12, 64).astype(np.float32)
    dcps = rng.uniform(-2e-3, 2e-3, 64).astype(np.float32)
    dci = rng.uniform(-2e-6, 2e-6, 64).astype(np.float32)
    n = rng.integers(NNOM - 2, NNOM + 3, 64).astype(np.int32)
    np.testing.assert_allclose(
        nco.advance_carrier(t(rem), t(dcps), t(n), tc).numpy(),
        np.asarray(jnco.advance_carrier(rem, dcps, jnp.asarray(n), jc)),
        atol=2e-7)
    np.testing.assert_allclose(
        nco.advance_code(t(remc), t(dci), t(n), tk).numpy(),
        np.asarray(jnco.advance_code(remc, dci, jnp.asarray(n), jk)),
        atol=2e-7)
    np.testing.assert_array_equal(
        nco.period_samples(t(remc), t(dci), tk).numpy(),
        np.asarray(jnco.period_samples(remc, dci, jk)))
    x = rng.uniform(-5, 5, 100).astype(np.float32)
    np.testing.assert_array_equal(nco.frac(t(x)).numpy(),
                                  np.asarray(jnco.frac(x)))


def test_carrier_phase_and_mix():
    jc, tc, _, _ = tables()
    rng = np.random.default_rng(1)
    d_cps, rem = np.float32(1.7e-4), np.float32(0.31)
    ph_j = np.asarray(jcarrier.carrier_phase(NNOM, d_cps, rem, jc))
    ph_t = carrier.carrier_phase(NNOM, t(d_cps), t(rem), tc).numpy()
    np.testing.assert_allclose(ph_t, ph_j, atol=2e-7)
    data = rng.integers(-20, 20, NNOM).astype(np.float32)
    np.testing.assert_allclose(
        carrier.mix_carrier(t(data), t(ph_j)).numpy(),
        np.asarray(jcarrier.mix_carrier(data, ph_j)), atol=2e-5)


def test_resample_chip_indices_and_code():
    _, _, jk, tk = tables()
    from gnsslib_tpu import codes
    code, _ = codes.gencode(7, 1)
    for remc, dci in ((0.013, 1.3e-6), (-0.1, -7e-7), (0.0, 0.0)):
        rc, di = np.float32(remc), np.float32(dci)
        ij = np.asarray(jres.code_chip_indices(NNOM + 30, rc, di, 8, jk))
        it = resample.code_chip_indices(NNOM + 30, t(rc), t(di), 8,
                                        tk).numpy()
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(
            resample.resample_code(t(code), t(it)).numpy(),
            np.asarray(jres.resample_code(code, ij)))


def test_correlator_taps():
    np.testing.assert_array_equal(correlator.tap_offsets(6, 3),
                                  jcorr.tap_offsets(6, 3))
    assert correlator.dll_tap_indices(6, 3, 6) == \
        jcorr.dll_tap_indices(6, 3, 6)
    rng = np.random.default_rng(2)
    smax, nwin = 8, 600
    offs = correlator.tap_offsets(4, 2)
    mixed = (rng.normal(size=(3, nwin)) + 1j * rng.normal(size=(3, nwin))
             ).astype(np.complex64)
    code = np.sign(rng.normal(size=(3, nwin + 2 * smax))).astype(np.float32)
    for nv in (nwin, nwin - 5):
        zj = np.asarray(jcorr.correlate_taps(mixed, code, offs, smax, nv))
        zt = correlator.correlate_taps(t(mixed), t(code), offs, smax,
                                       nv).numpy()
        # f32 sums of ~600 unit products: order-of-summation bound
        np.testing.assert_allclose(zt, zj, atol=1e-4 * np.sqrt(nwin))


def test_fftcorr_power():
    rng = np.random.default_rng(3)
    nfft, n = 1024, 500
    code = np.sign(rng.normal(size=(2, n))).astype(np.float32)
    cj = np.asarray(jfft.code_fft_conj(code, nfft))
    ct = fftcorr.code_fft_conj(t(code), nfft).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    mixed = (rng.normal(size=(2, 5, nfft))
             + 1j * rng.normal(size=(2, 5, nfft))).astype(np.complex64)
    pj = np.asarray(jfft.fft_correlate_power(mixed, cj[:, None], n))
    pt = fftcorr.fft_correlate_power(t(mixed), t(cj)[:, None], n).numpy()
    # complex64 FFT round-off relative to the largest power
    np.testing.assert_allclose(pt, pj, atol=1e-5 * pj.max())
    assert fftcorr.next_pow2(1000) == jfft.next_pow2(1000) == 1024


@pytest.mark.parametrize("lo,hi", [(3, 9), (9, 3), (0, 0), (15, 15)])
def test_stats_exclusion_and_masked(lo, hi):
    np.testing.assert_array_equal(
        stats.exclusion_mask(16, torch.tensor(lo), torch.tensor(hi)).numpy(),
        np.asarray(jstats.exclusion_mask(16, lo, hi)))
    rng = np.random.default_rng(lo * 31 + hi)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    mask = np.asarray(jstats.exclusion_mask(16, lo, hi))[None].repeat(4, 0)
    vj, ij = jstats.masked_max(x, mask)
    vt, it = stats.masked_max(t(x), t(mask))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(stats.masked_mean(t(x), t(mask)).numpy(),
                               np.asarray(jstats.masked_mean(x, mask)),
                               atol=1e-6)


def test_stats_lagrange_interp():
    x = np.linspace(0.0, 1.0, 12)
    y = np.sin(3 * x)
    tt = np.asarray([0.05, 0.33, 0.5, 0.91])
    np.testing.assert_allclose(
        stats.lagrange_interp(t(x), t(y), t(tt)).numpy(),
        np.asarray(jstats.lagrange_interp(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(tt))), rtol=1e-6)
