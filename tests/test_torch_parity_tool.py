"""The port's ``parity_vs_reference`` against the JAX package's
``tools/parity_vs_reference.py`` (loaded from ``tools/`` by path), on the
CPU and without the reference tree:

- every scenario's synthesized capture equals the JAX tool's bytes (1 s
  of each two-satellite capture; one short ``_fullenv_chunk`` each for
  ``fullenv`` and ``fullenv_glo``, so no test writes the shared
  ``fullenv`` caches);
- ``write_configs`` writes the same INI text for every scenario, apart
  from the paths;
- ``parse_obs`` and ``parse_novatel_sbas`` give the JAX functions' results
  on the same bytes;
- ``compare`` on built observation pairs (a whole-millisecond TOW slip,
  single-epoch Doppler spikes, blank fields, per-satellite carrier
  constants, a GPS/GLONASS split), against the statistics and gates the
  construction fixes;
- the ``refshim`` copy equals ``tools/refshim`` byte for byte;
- without the reference tree the tool raises ``FileNotFoundError``
  naming the path before it synthesizes anything."""
import filecmp
import importlib.util
import os

import numpy as np
import pytest

from gnsslib_tpu_torch.tools import parity_vs_reference as pvr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_SAT = ("gps", "weak", "ppm", "highdyn")


@pytest.fixture(scope="module")
def jtool():
    """The JAX package's tool as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_parity_vs_reference",
        os.path.join(ROOT, "tools", "parity_vs_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(tool, scenario: str, workdir: str) -> bytes:
    if scenario in TWO_SAT:
        path = tool.synthesize(workdir, seconds=1.0,
                               **tool.SCENARIOS[scenario]["knobs"])
    elif scenario == "glo":
        path = tool.synthesize_glo(workdir, seconds=1.0)
    else:
        path = tool.synthesize_sbas(workdir, seconds=1.0)
    return open(path, "rb").read()


def _fullenv_chunk(tool, glo: bool) -> bytes:
    """One 40,000-sample chunk 3 s into the capture, at the JAX tool's
    noise and scale (the chunk the tool's pool computes)."""
    noise, scale = _levels()
    t0 = 3 * 16368000
    got_t0, q = tool._fullenv_chunk((t0, 40000, noise, scale, glo))
    assert got_t0 == t0
    return q.tobytes()


@pytest.mark.parametrize("scenario", ["gps", "weak", "ppm", "highdyn",
                                      "glo", "sbas", "fullenv",
                                      "fullenv_glo"])
def test_synthesis_equals_jax_tool(jtool, scenario, tmp_path):
    """The port's capture of ``scenario`` has the JAX tool's bytes."""
    if scenario.startswith("fullenv"):
        glo = scenario == "fullenv_glo"
        mine, theirs = _fullenv_chunk(pvr, glo), _fullenv_chunk(jtool, glo)
        assert len(mine) == 40000
        assert pvr.fullenv_levels(glo) == _levels()
    else:
        (tmp_path / "a").mkdir()
        (tmp_path / "b").mkdir()
        mine = _capture(pvr, scenario, str(tmp_path / "a"))
        theirs = _capture(jtool, scenario, str(tmp_path / "b"))
        iq = scenario == "ppm"
        assert len(mine) == int(2.048e6 if iq else 4.092e6) * (2 if iq
                                                                else 1)
    assert mine == theirs


def _levels():
    """The JAX tool's noise sigma and int8 scale of its fullenv captures
    (computed inline in its ``synthesize_fullenv``)."""
    from gnsslib_tpu import sim as jsim
    from gnsslib_tpu.constants import DType
    noise = jsim.noise_std_for_cn0(1.0, 46.0, 16.368e6, DType.REAL)
    return (noise, 110.0 / (3.0 * np.sqrt(noise ** 2 + 32.0 / 2.0)))


def _configs(tool, scenario: str, workdir: str) -> dict:
    knobs = tool.SCENARIOS[scenario]["knobs"]
    tool.write_configs.scenario = scenario
    tool.write_configs(workdir, "/data/capture.bin",
                       ppm=knobs.get("ppm", 0.0), rtl=knobs.get("rtl", False))
    return {name: open(os.path.join(workdir, name)).read()
            .replace(workdir, "<workdir>")
            for name in ("fend.ini", "cli_ref.ini", "cli_mine.ini")}


@pytest.mark.parametrize("scenario", sorted(pvr.SCENARIOS))
def test_write_configs_equal_jax_tool(jtool, scenario, tmp_path):
    """The same INI text as the JAX tool's for every scenario, apart from
    the work directory (the SBAS ports, TRACK and FEND sections too)."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    mine = _configs(pvr, scenario, str(tmp_path / "a"))
    theirs = _configs(jtool, scenario, str(tmp_path / "b"))
    assert mine == theirs
    assert pvr.SCENARIOS == jtool.SCENARIOS
    assert pvr.SBAS_PORTS == jtool.SBAS_PORTS


def _rinex(path) -> None:
    """A RINEX observation file of three systems: blank fields, negative
    Doppler, fractional seconds, a GLONASS and an SBAS satellite."""
    from gnsslib_tpu_torch.constants import SYS_GLO, SYS_GPS, SYS_SBS
    from gnsslib_tpu_torch.obs.epoch import SdrObs
    from gnsslib_tpu_torch.obs.rinex import RinexObsWriter
    w = RinexObsWriter(str(path))
    for k in range(4):
        tow = 352800.4688 + 0.4 * k
        w.write_epoch([
            SdrObs(sys=SYS_GPS, prn=3, week=2200, tow=tow,
                   P=21123456.789 + k, L=111001234.567, D=1234.5, S=45.2),
            SdrObs(sys=SYS_GPS, prn=17, week=2200, tow=tow,
                   P=0.0 if k == 2 else 23987654.321,
                   L=126065432.109, D=-2345.5, S=40.7),
            SdrObs(sys=SYS_GLO, prn=5, week=2200, tow=tow, P=22456789.012,
                   L=120123456.789, D=987.25, S=44.1),
            SdrObs(sys=SYS_SBS, prn=129, week=2200, tow=tow, P=38222333.444,
                   L=0.0, D=12.5, S=38.3)])


def _novatel() -> bytes:
    """A NovAtel RAWSBASFRAME stream of nine messages with junk between."""
    from gnsslib_tpu_torch.nav.sbas import (SbasMsg, decode_l1sbas_bits,
                                            encode_sbas_message,
                                            gen_novatel_sbasmsg)
    rng = np.random.default_rng(5)
    sb = SbasMsg(week=2200, tow=352800.0)
    out = b"\xaa\x44"                   # a cut header before the frames
    for k in range(9):
        msg = encode_sbas_message(63, rng.integers(0, 2, 212),
                                  (0x53, 0x9A, 0xC6)[k % 3])
        decode_l1sbas_bits(msg, 1, sb, ref_week=2200)
        gen_novatel_sbasmsg(sb)
        out += bytes(sb.novatelmsg) + (b"\xaa\x44\x12\x00" if k == 4
                                       else b"")
    return out + b"\xaa\x44\x12"        # a cut frame at the end


def test_parsers_equal_jax_tool(jtool, tmp_path):
    """``parse_obs`` and ``parse_novatel_sbas`` equal the JAX tool's on
    the same bytes (NaN for a blank field in both)."""
    path = tmp_path / "o.obs"
    _rinex(path)
    mine, theirs = pvr.parse_obs(str(path)), jtool.parse_obs(str(path))
    assert len(mine) == 16 and mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    assert sum(np.isnan(v[0]) for (_, p), v in mine.items()
               if p == ("G", 17)) == 1
    assert all(np.isnan(v[1]) for (_, p), v in mine.items()
               if p == ("S", 29))
    assert {p for _, p in mine} == {("G", 3), ("G", 17), ("R", 5),
                                    ("S", 29)}
    data = _novatel()
    frames = pvr.parse_novatel_sbas(data)
    assert frames == jtool.parse_novatel_sbas(data)
    assert len(frames) == 9 and all(i == 63 for _, i, _ in frames)
    assert len({p for p, _, _ in frames}) == 9


# compare() on built pairs: 3 GPS satellites and (where asked) 2 GLONASS
# ones over 60 epochs, the port's side at constructed offsets from the
# reference's side
EPOCHS = [352800.0 + 0.4 * k for k in range(60)]
P_NOISE = (0.8, -0.8)           # alternating pseudorange residuals (m)
D_NOISE = (0.1, -0.1)           # alternating Doppler residuals (Hz)


def _pairs(glo: bool = False, isb: float = 0.0):
    ref, mine = {}, {}
    sats = [("G", 3), ("G", 11), ("G", 19)] + ([("R", 1), ("R", 4)]
                                              if glo else [])
    for k, t in enumerate(EPOCHS):
        for j, sat in enumerate(sats):
            P = 2.1e7 + 1e5 * j + 10.0 * k
            L = 1.1e8 + 50.0 * k
            D = 1000.0 * (j + 1)
            ref[(round(t, 3), sat)] = [P, L, D, 45.0]
            mine[(round(t, 3), sat)] = [
                P + 3.0 + P_NOISE[k % 2] + (isb if sat[0] == "R" else 0.0),
                L + 1000.0 * (j + 1),   # the satellite's carrier constant
                D + D_NOISE[(k + j) % 2], 45.0]
    return ref, mine


def test_compare_on_built_pairs():
    """The statistics the construction fixes: a +3 m clock offset
    (removed by the clock-free RMS), ±0.8 m and ±0.1 Hz of residual,
    per-satellite carrier constants (no spread), one reference TOW slip
    (a whole millisecond), two single-epoch Doppler spikes, blank fields
    in two pairs, and an epoch only one side has."""
    ref, mine = _pairs()
    keys = sorted(ref)
    ref[keys[10]][0] += 299792.458          # a 1 ms TOW slip
    ref[keys[20]][2] += 40.0                # Doppler spikes
    ref[keys[21]][2] -= 60.0
    ref[keys[30]][0] = np.nan               # blank fields
    mine[keys[40]][2] = np.nan
    mine[(round(EPOCHS[-1] + 0.4, 3), ("G", 3))] = [2.1e7, 1.1e8, 1e3, 45.]
    st = pvr.compare(ref, mine, "gps")
    n = len(keys)                           # 180 common pairs
    assert st["n_common"] == n and st["n_ref"] == n
    assert st["n_mine"] == n + 1 and st["nan_pairs"] == 2
    assert st["outlier_frac"] == pytest.approx(3 / (n - 2))
    assert st["d_outlier_frac"] == pytest.approx(2 / (n - 2))
    # the inliers: the residuals' constant and alternating parts
    assert st["p_mean"] == pytest.approx(3.0, abs=0.05)
    assert st["p_rms_clockfree"] == pytest.approx(0.8, abs=0.05)
    assert st["p_max"] == pytest.approx(3.8, abs=1e-6)
    assert st["d_rms"] == pytest.approx(0.1, abs=1e-6)
    assert st["l_spread"] < 1e-6
    assert st["n_glo"] == 0 and "p_isb" not in st and st["ok"]
    # the same pairs fail the envelope once the residuals grow
    loud = {k: [v[0] + 12.0 * (i % 2), v[1], v[2], v[3]]
            for i, (k, v) in enumerate(sorted(mine.items()))}
    assert not pvr.compare(ref, loud, "gps")["ok"]


@pytest.mark.parametrize("isb, ok", [(0.0, True), (7.0, False)])
def test_compare_gps_glonass_split(isb, ok):
    """``fullenv_glo``-style gates on a GPS + GLONASS set: the GLONASS
    count and the residual split between the systems (``p_isb``)."""
    ref, mine = _pairs(glo=True, isb=isb)
    st = pvr.compare(ref, mine, "glo")
    assert st["n_glo"] == 2 * len(EPOCHS)
    assert st["p_isb"] == pytest.approx(isb, abs=1e-6)
    assert st["ok"] is ok
    # fullenv_glo asks for 250 inlier pairs: 300 pass, 200 do not
    assert pvr.compare(ref, mine, "fullenv_glo")["ok"] is ok
    early = [k for k in ref if k[0] < round(EPOCHS[40], 3)]
    assert not pvr.compare({k: ref[k] for k in early},
                           {k: mine[k] for k in early}, "fullenv_glo")["ok"]


def test_compare_sbas_frames():
    """The SBAS gates: common payloads, message ids, S Doppler."""
    ref, mine = _pairs()
    for k, t in enumerate(EPOCHS[:20]):
        ref[(round(t, 3), ("S", 29))] = [3.8e7, 2e8, 12.5, 38.0]
        mine[(round(t, 3), ("S", 29))] = [3.8e7 + 5e3, 2e8, 12.6, 38.0]
    frames = [(bytes([i]) * 29, 63, 352800.0 + i) for i in range(10)]
    st = pvr.compare(ref, mine, "sbas", frames, frames[1:])
    assert st["sbas_msgs_common"] == 9 and st["sbas_id_mismatch"] == 0
    assert st["n_sbs"] == 20
    assert st["sbas_d_rms"] == pytest.approx(0.1, abs=1e-6)
    assert st["ok"]
    wrong = [(p, 12, t) for p, _, t in frames]
    assert not pvr.compare(ref, mine, "sbas", frames, wrong)["ok"]


def test_refshim_copy_equals_original():
    """``gnsslib_tpu_torch/tools/refshim`` is ``tools/refshim``, byte for
    byte, file for file."""
    a = os.path.join(ROOT, "tools", "refshim")
    b = os.path.join(ROOT, "gnsslib_tpu_torch", "tools", "refshim")
    names = []
    for dirpath, _, files in os.walk(a):
        rel = os.path.relpath(dirpath, a)
        assert sorted(os.listdir(os.path.join(b, rel))) == \
            sorted(os.listdir(dirpath))
        names += [os.path.join(rel, f) for f in files]
    assert len(names) == 10
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert (mismatch, errors) == ([], [])


def test_without_reference_tree_raises_first(monkeypatch, tmp_path):
    """No ``src/`` under the reference root: ``FileNotFoundError`` naming
    the path, before any capture is synthesized."""
    missing = tmp_path / "no-reference"
    monkeypatch.setattr(pvr, "REF", str(missing))
    made = []
    monkeypatch.setattr(pvr, "synthesize",
                        lambda *a, **k: made.append(a))
    with pytest.raises(FileNotFoundError, match=str(missing / "src")):
        pvr.run(scenario="gps", device="cpu")
    assert made == []
