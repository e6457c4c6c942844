"""The smoke script's captures: ``chip_smoke._synthesize`` (torch float64,
run on the card by phase 4) gives ``sim.synthesize``'s signal for every
capture kind, and ``chip_smoke._quantize`` gives ``sim``'s sample
formats, on the CPU."""
import os
import sys

import numpy as np
import pytest
import torch

from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.constants import DType
from gnsslib_tpu_torch.tools import receiver_throughput as rxt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")


def _kinds():
    starts = cs.edge_starts()
    edge = {p: (starts[p], d) for p, d in cs.EDGE_DOPPLER.items()}
    return {"slice": (cs.F_SF, cs.F_IF, cs.TRUTH),
            "pos": (cs.F_SF, cs.F_IF, cs.TRUTH),
            "fe1": (cs.F_SF, cs.F_IF, cs.multi_truth()),
            "fe2": (cs.F_SF, 0.0, cs.multi_truth()),
            "rtl": (cs.RTL_SF, 0.0, cs.RTL_TRUTH),
            "edge": (cs.F_SF, cs.F_IF, edge),
            "mh": (cs.MH_SF, cs.MH_IF, None),
            "rx": (rxt.F_SF, rxt.F_IF, None)}


@pytest.mark.parametrize("kind", ["slice", "pos", "fe1", "fe2", "rtl",
                                  "edge", "mh", "rx"])
def test_synthesize_matches_sim(kind):
    """20,000 noiseless samples at the capture's start and 27 s in (the
    positioning capture's dark seconds): within 1e-12 of
    ``sim.synthesize`` (float64, amplitudes ~1 per satellite), and the
    same bytes once quantized (phase 14's: the bytes of
    ``receiver_throughput``'s own chunk without noise)."""
    f_sf, f_if, truth = _kinds()[kind]
    for t0 in (0, int(27 * f_sf) if kind == "pos" else int(3 * f_sf)):
        chans, dtype, _, fmt = cs._signal(kind, t0, f_sf, truth)
        ref = sim.synthesize(chans, f_sf, f_if, dtype, 20000, t0=t0)
        got = cs._synthesize(CPU, chans, f_sf, f_if, dtype == DType.IQ,
                             20000, 0.0, 0, t0).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        scale = cs.RX_LEVELS[1] if kind == "rx" else cs.QUANT
        q = (sim.quantize_int8(ref, scale) if fmt == "int8"
             else sim.quantize_rtlsdr(ref, 8.0))
        assert cs._quantize(torch.from_numpy(got), fmt, scale) == \
            q.tobytes()
        if kind == "rx":
            _, tool = rxt._synth_chunk((t0, 20000, 0.0, cs.RX_SECONDS))
            assert tool.tobytes() == q.tobytes()
    if kind == "pos":
        # the faded satellite is left out of its dark seconds only
        assert len(cs._signal(kind, 0, f_sf, truth)[0]) == \
            len(cs._signal(kind, int(27 * f_sf), f_sf, truth)[0]) + 1


def test_noise_and_quantizers():
    """The noise: sigma as asked, the same draw for the same seed, another
    for another seed; the quantizers equal ``sim``'s on noisy I/Q."""
    x1 = cs._synthesize(CPU, [], cs.F_SF, cs.F_IF, False, 200000, 12.8, 7, 0)
    x2 = cs._synthesize(CPU, [], cs.F_SF, cs.F_IF, False, 200000, 12.8, 7, 0)
    x3 = cs._synthesize(CPU, [], cs.F_SF, cs.F_IF, False, 200000, 12.8, 8, 0)
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    assert float(x1.std()) == pytest.approx(12.8, rel=0.01)
    r = np.random.default_rng(0).normal(0.0, 30.0, (1000, 2))
    assert cs._quantize(torch.from_numpy(r), "int8") == \
        sim.quantize_int8(r, cs.QUANT).tobytes()
    assert cs._quantize(torch.from_numpy(r), "rtlsdr") == \
        sim.quantize_rtlsdr(r, 8.0).tobytes()


@pytest.mark.parametrize("kind", ["ramp", "par_ppm", "par_glo", "par_sbas",
                                  "par_fullenv_glo"])
def test_parity_captures_match_sim(kind):
    """Phase 16's captures (``chip_smoke.parity_signal``): the 30 Hz/s
    ramp, the RTL-SDR u8 I/Q capture with its +5 ppm LO offset, GPS + G1
    and GPS + SBAS symbols at 4.092 Msps, and a ``fullenv_glo`` chunk;
    20,000 noiseless samples 3 s in within 1e-12 of ``sim.synthesize``,
    and the same bytes once quantized at the capture's scale and format
    (the ``fullenv_glo`` chunk: the parity tool's own chunk without
    noise)."""
    from gnsslib_tpu_torch.tools import parity_vs_reference as pvr
    chans, seconds, f_sf, f_if, iq, noise, scale, fmt, _ = \
        cs.parity_signal(kind)
    t0 = int(3 * f_sf)
    dtype = DType.IQ if iq else DType.REAL
    ref = sim.synthesize(chans, f_sf, f_if, dtype, 20000, t0=t0)
    got = cs._synthesize(CPU, chans, f_sf, f_if, iq, 20000, 0.0, 0,
                         t0).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    q = (sim.quantize_int8(ref, scale) if fmt == "int8"
         else sim.quantize_rtlsdr(ref, scale))
    assert cs._quantize(torch.from_numpy(got), fmt, scale,
                        rtl_scale=scale) == q.tobytes()
    want = {"ramp": (26.0, 4.092e6, False, "int8", 2),
            "par_ppm": (32.0, 2.048e6, True, "rtlsdr", 2),
            "par_glo": (40.0, 4.092e6, False, "int8", 2),
            "par_sbas": (30.0, 4.092e6, False, "int8", 2),
            "par_fullenv_glo": (30.0, 16.368e6, False, "int8", 32)}[kind]
    assert (seconds, f_sf, iq, fmt, len(chans)) == want
    if kind == "ramp":
        assert [c.doppler_rate for c in chans] == [cs.RAMP_RATE] * 2
        assert scale == 4.0
    if kind == "par_ppm":
        assert [c.foffset for c in chans] == \
            [pytest.approx(5e-6 * 1.57542e9)] * 2
    if kind == "par_fullenv_glo":
        _, tool = pvr._fullenv_chunk((t0, 20000, 0.0, scale, True))
        assert tool.tobytes() == q.tobytes()
