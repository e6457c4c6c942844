"""The benchmark's generator against the receiver package's simulator:
the same codes, LNAV and SBAS bits, and the same int8 samples for the
same channels (noise left out: the two draw it from different
generators)."""
from __future__ import annotations

import numpy as np

from rxbench import sky

MIX = dict(gps_range_km=[20000.0, 26000.0], sbas_range_km=[37000.0, 40000.0],
           gps_doppler_hz=1500.0, sbas_doppler_hz=200.0, gps_rate_hz_s=0.9,
           sbas_rate_hz_s=0.01, cn0_dbhz=46.0)


def test_codes_and_nav_bits():
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.codes import gencode
    from gnsslib_tpu_torch.constants import CodeType
    from gnsslib_tpu_torch.tools import parity_vs_reference as pv
    for prn in (1, 7, 12, 32, 129, 133, 138):
        assert np.array_equal(sky.ca_code(prn),
                              gencode(prn, CodeType.L1CA)[0])
    eph = sim.example_eph(prn=3, week=sky.WEEK, toe_tow=sky.TOW0)
    ref = sim.lnav_bit_stream(eph, sky.TOW0 + 6.0, nframes=3)
    assert np.array_equal(sky.lnav_stream(96.0)[300:300 + len(ref)], ref)
    # a lead of 1 s puts 50 more pad bits first; the rest is unchanged
    assert np.array_equal(sky.lnav_stream(96.0, lead=1.0)[50:],
                          sky.lnav_stream(96.0))
    msgs = sky.sbas_messages(12, np.random.default_rng(12))
    assert all(np.array_equal(1 - 2 * a, b)
               for a, b in zip(msgs, pv.sbas_messages(12)))
    assert np.array_equal(sky.sbas_symbols(msgs), pv.sbas_symbols(12))


def test_int8_samples_match_the_simulator():
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.constants import CodeType, DType
    mix = dict(MIX, gps=[3, 9, 21], sbas=[129])
    sk = sky.draw_sky(mix, np.random.default_rng(2 ** 31 + 5), 3.0)
    f_sf, f_if, n = 16.368e6, 4.092e6, 150_000
    mine = sky.synthesize(sk, f_sf, f_if, n, device="cpu", noise_seed=None,
                          scale=3.0, chunk=40_000).numpy()
    chans = [sim.SimChannel(
        prn=s.prn, ctype=CodeType.L1CA if s.kind == "gps"
        else CodeType.L1SBAS, doppler=s.doppler, doppler_rate=s.rate,
        code_phase=s.code_phase,
        carr_phase=s.carr_phase, nav_bits=s.nav_bits, nav_ms=s.nav_ms)
        for s in sk.signals]
    ref = sim.quantize_int8(sim.synthesize(chans, f_sf, f_if, DType.REAL, n),
                            3.0)
    assert mine.dtype == np.int8 and np.array_equal(mine, ref)


def test_seed_sets_the_draws_and_the_noise():
    mix = dict(MIX, gps=[1, 2], sbas=[])
    a = sky.draw_sky(mix, np.random.default_rng([2 ** 33 + 1, 0]), 2.0)
    b = sky.draw_sky(mix, np.random.default_rng([2 ** 33 + 1, 0]), 2.0)
    c = sky.draw_sky(mix, np.random.default_rng([2 ** 33 + 2, 0]), 2.0)
    assert [s.doppler for s in a.signals] == [s.doppler for s in b.signals]
    assert [s.doppler for s in a.signals] != [s.doppler for s in c.signals]
    x = sky.synthesize(a, 4.092e6, 1.023e6, 20_000, device="cpu",
                       noise_seed=7)
    y = sky.synthesize(a, 4.092e6, 1.023e6, 20_000, device="cpu",
                       noise_seed=7)
    assert np.array_equal(x.numpy(), y.numpy())


def test_sky_spreads_flight_times_rates_and_ephemerides():
    """Each satellite has its own time of flight (tens of ms apart), its
    own Doppler rate, and its own ephemeris in its subframes."""
    mix = dict(MIX, gps=list(range(1, 13)), sbas=[129, 133])
    sk = sky.draw_sky(mix, np.random.default_rng(2 ** 31 + 9), 30.0)
    gps = [s for s in sk.signals if s.kind == "gps"]
    delays = [s.delay for s in gps]
    assert all(20e6 / sky.CLIGHT <= d <= 26e6 / sky.CLIGHT for d in delays)
    assert max(delays) - min(delays) > 5e-3
    assert len({round(s.rate, 6) for s in gps}) == len(gps)
    assert all(abs(s.rate) <= 0.9 for s in gps)
    assert len({tuple(s.nav_bits[400:2000]) for s in gps}) == len(gps)
    recs = [sky.eph_rinex(p) for p in range(1, 33)]
    for key in ("M0", "OMG0", "omg", "i0", "e", "sqrtA", "iode"):
        assert len({r[key] for r in recs}) > 1
    assert all(recs[i] != recs[j] for i in range(32) for j in range(i))


def _rinex_value(v: float) -> str:
    if v == 0.0:
        return " .000000000000E+00"
    e = int(np.floor(np.log10(abs(v)))) + 1
    m = round(abs(v) / 10.0 ** e, 12)
    if m >= 1.0:
        m, e = m / 10.0, e + 1
    return ("-" if v < 0 else " ") + f"{m:.12f}"[1:] + f"E{e:+03d}"


def _rinex_record(prn: int, eph: dict) -> str:
    from rxbench import truth
    vals = [0.0] * 28
    for name, idx in truth.NAV_FIELDS.items():
        vals[idx] = eph[name]
    lines = [f"G{prn:02d} 2022 03 09 02 00 00"
             + "".join(map(_rinex_value, vals[:3]))]
    for k in range(3, 28, 4):
        lines.append("    " + "".join(map(_rinex_value, vals[k:k + 4])))
    return "\n".join(lines)


def test_ephemeris_under_another_prn_reads_bad():
    """RINEX records of each satellite's own ephemeris read sound; the
    same records with two PRNs traded read bad twice."""
    from rxbench import truth
    mix = dict(MIX, gps=[3, 9], sbas=[])
    sk = sky.draw_sky(mix, np.random.default_rng(5), 10.0)
    job = dict(seconds=10.0, events=[], sbas_bytes=b"")

    def nav(pairs):
        return "     END OF HEADER\n" + "\n".join(
            _rinex_record(p, sky.eph_rinex(q)) for p, q in pairs) + "\n"
    assert len(truth.parse_rinex_nav(nav([(3, 3), (9, 9)]))) == 2
    assert truth.judge_nav(dict(job, rinex_nav=nav([(3, 3), (9, 9)])),
                           sk) == (0, 0)
    assert truth.judge_nav(dict(job, rinex_nav=nav([(3, 9), (9, 3)])),
                           sk)[0] == 2
