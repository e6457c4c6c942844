"""The port's in-process driver bindings (io/bladerf.py, gn3s.py,
stereo.py) against the repo's mock vendor libraries (tools/mock_bladerf.c,
mock_stereo.c, mock_gn3s_usb.c, built with gcc into the test's temporary
directory), counterparts of the JAX package's tests/test_live_bindings.py:
each binding's configuration sequence, grabber transfers into the sample
ring, and byte-format decode; and the port's CLI end to end with
``TYPE=RTLSDR`` on tools/mock_rtlsdr.c (acquisition and tracking from the
live ring through ``run_live``, in a process of its own).  The RTL-SDR
binding's own tests are tests/test_torch_rtlsdr_binding.py: run before
the JAX package's bladeRF binding in one process, its ctypes calls leave
the stack words that binding's undeclared size_t arguments pick up (the
JAX package's own files crash in that order too), so they live in a file
the scheduler gives out after tests/test_live_bindings.py."""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from gnsslib_tpu_torch.constants import DType, FrontendType
from gnsslib_tpu_torch.io.frontend import FrontendSpec

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")


def _build(tmp_path_factory, name: str) -> str:
    tmp = tmp_path_factory.mktemp(f"mock_{name}")
    so = str(tmp / f"libmock_{name}.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", so,
                    os.path.join(REPO, "tools", f"mock_{name}.c")],
                   check=True, capture_output=True)
    return so


def _lcg_bytes(n: int) -> np.ndarray:
    x = np.empty(n, np.uint8)
    s = 1
    for i in range(n):
        s = (1103515245 * s + 12345) & 0x7FFFFFFF
        x[i] = (s >> 16) & 0xFF
    return x


def _lcg_int16(n: int) -> np.ndarray:
    x = np.empty(n, np.uint16)
    s = 1
    for i in range(n):
        s = (1103515245 * s + 12345) & 0x7FFFFFFF
        x[i] = (s >> 8) & 0xFFFF
    return x.astype(np.int16)


# --- bladeRF ------------------------------------------------------------------


@pytest.fixture(scope="module")
def bladerf_lib(tmp_path_factory):
    return _build(tmp_path_factory, "bladerf")


def test_bladerf_configures_and_streams(bladerf_lib):
    from gnsslib_tpu_torch.io.bladerf import BladeRfFrontend
    from gnsslib_tpu_torch.io.formats import unpack_bladerf
    spec = FrontendSpec(fend=FrontendType.BLADERF, f_cf=1.57542e9,
                        f_sf=4.0e6, f_if=0.0, dtype=DType.IQ)
    with BladeRfFrontend(spec, lib=bladerf_lib) as fe:
        m = ctypes.CDLL(bladerf_lib)
        m.mock_bladerf_get_freq.restype = ctypes.c_uint32
        m.mock_bladerf_get_bw.restype = ctypes.c_uint32
        m.mock_bladerf_get_rate.restype = ctypes.c_uint32
        # bladerf_initconf programming (bladerf.c:127-154)
        assert m.mock_bladerf_get_freq() == 1575420000
        assert m.mock_bladerf_get_bw() == 2000000       # f_sf / 2
        assert m.mock_bladerf_get_rate() == 4000000
        assert m.mock_bladerf_get_enabled() == 1

        n = 8192
        x = fe.read(0, n)
        assert x.shape == (n, 2)
        # byte-exact: same SC16 LCG stream -> 12-bit mask + per-block DC
        # removal (the file-replay twin decode, bladerf.c:216-261)
        expect = unpack_bladerf(_lcg_int16(2 * n).tobytes())
        np.testing.assert_array_equal(x, expect)
        assert fe.overruns == 0
    assert fe.eof


def test_bladerf_fpga_load_branch(bladerf_lib, monkeypatch):
    from gnsslib_tpu_torch.io.bladerf import BladeRfFrontend
    spec = FrontendSpec(fend=FrontendType.BLADERF, f_cf=1.57542e9,
                        f_sf=4.0e6, f_if=0.0, dtype=DType.IQ)
    monkeypatch.setenv("MOCK_BLADERF_UNCONFIGURED", "1")
    # no image given -> the bladerf_init error path (bladerf.c:73-97)
    with pytest.raises(OSError, match="FPGA"):
        BladeRfFrontend(spec, lib=bladerf_lib)
    with BladeRfFrontend(spec, fpga="hostedx115.rbf",
                         lib=bladerf_lib) as fe:
        m = ctypes.CDLL(bladerf_lib)
        assert m.mock_bladerf_get_fpga_loaded() == 1
        fe.read(0, 256)


def test_bladerf_rejects_real_dtype(bladerf_lib):
    from gnsslib_tpu_torch.io.bladerf import BladeRfFrontend
    spec = FrontendSpec(fend=FrontendType.BLADERF, f_cf=1.57542e9,
                        f_sf=4.0e6, f_if=0.0, dtype=DType.REAL)
    with pytest.raises(ValueError):
        BladeRfFrontend(spec, lib=bladerf_lib)


# --- NSL STEREO ---------------------------------------------------------------


@pytest.fixture(scope="module")
def stereo_lib(tmp_path_factory):
    return _build(tmp_path_factory, "stereo")


def test_stereo_streams_both_paths(stereo_lib):
    from gnsslib_tpu_torch.io.stereo import StereoFrontend
    from gnsslib_tpu_torch.io.formats import (unpack_stereo_fe1,
                                              unpack_stereo_fe2)
    spec = FrontendSpec(fend=FrontendType.STEREO, f_cf=1.57542e9,
                        f_sf=26e6, f_if=6.5e6, dtype=DType.REAL, ftype=1)
    with StereoFrontend(spec, lib=stereo_lib) as fe:
        assert fe.pkt_size == 8192
        n = 16384
        x1 = fe.read(0, n)
        raw = _lcg_bytes(n).tobytes()
        np.testing.assert_array_equal(x1, unpack_stereo_fe1(raw))
        # FE2 view shares the ring: dual 3-bit I/Q from the SAME bytes
        fe2 = fe.fe2(FrontendSpec(fend=FrontendType.STEREO, f_cf=1.2e9,
                                  f_sf=26e6, f_if=0.0, dtype=DType.IQ,
                                  ftype=2))
        x2 = fe2.read(0, n)
        assert x2.shape == (n, 2)
        np.testing.assert_array_equal(x2, unpack_stereo_fe2(raw))
        assert not fe.usb_overrun
    assert fe.eof
    m = ctypes.CDLL(stereo_lib)
    assert m.mock_stereo_get_grab() == 0          # GrabStop ran


def test_stereo_overrun_is_fatal(stereo_lib, monkeypatch):
    from gnsslib_tpu_torch.io.stereo import StereoFrontend
    spec = FrontendSpec(fend=FrontendType.STEREO, f_cf=1.57542e9,
                        f_sf=26e6, f_if=6.5e6, dtype=DType.REAL)
    monkeypatch.setenv("MOCK_STEREO_OVERRUN_AFTER", "2")
    with StereoFrontend(spec, lib=stereo_lib) as fe:
        deadline = time.monotonic() + 10.0
        while not fe.eof and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fe.eof                             # grabber stopped
        assert fe.usb_overrun                     # sdrrcv.c:330-334
        assert fe.nsamples == 2 * 8192            # packets before overrun


def test_stereo_disconnected(stereo_lib, monkeypatch):
    from gnsslib_tpu_torch.io.stereo import StereoFrontend
    spec = FrontendSpec(fend=FrontendType.STEREO, f_cf=1.57542e9,
                        f_sf=26e6, f_if=6.5e6, dtype=DType.REAL)
    monkeypatch.setenv("MOCK_STEREO_DISCONNECTED", "1")
    with pytest.raises(OSError, match="connected"):
        StereoFrontend(spec, lib=stereo_lib)


# --- GN3S ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def gn3s_lib(tmp_path_factory):
    return _build(tmp_path_factory, "gn3s_usb")


def test_gn3s_v3_init_sequence_and_stream(gn3s_lib, monkeypatch):
    from gnsslib_tpu_torch.io.gn3s import Gn3sFrontend
    from gnsslib_tpu_torch.io.formats import unpack_gn3s_v3_2bit
    monkeypatch.setenv("MOCK_GN3S_PID", "0x0b3a")
    spec = FrontendSpec(fend=FrontendType.GN3SV3, f_cf=1.57542e9,
                        f_sf=16.368e6, f_if=4.092e6, dtype=DType.REAL)
    with Gn3sFrontend(spec, lib=gn3s_lib) as fe:
        assert fe.version == 3
        m = ctypes.CDLL(gn3s_lib)
        m.mock_usb_seq.restype = ctypes.c_uint64
        assert m.mock_usb_get_claimed() == 2      # RX_INTERFACE
        # FX2 programming order of gn3s.cpp:60-69 (reqtype,req,val,idx)
        seq = [m.mock_usb_seq(i) for i in range(m.mock_usb_seq_len())]
        vend = [((s >> 32) & 0xFF, (s >> 16) & 0xFFFF) for s in seq
                if (s >> 48) == 0x40]             # vendor-OUT only
        assert vend[:6] == [(0x08, 0), (0x0F, 132), (0x01, 0), (0x01, 1),
                            (0x01, 0), (0x0F, 32)]
        assert vend[6] == (0x01, 1)
        n = 32768
        x = fe.read(0, n)
        np.testing.assert_array_equal(
            x, unpack_gn3s_v3_2bit(_lcg_bytes(n).tobytes()))
        assert not fe.usb_overrun
    assert fe.eof


@pytest.mark.parametrize("shift", ["0", "1"])
def test_gn3s_v2_packet_shift(gn3s_lib, monkeypatch, shift):
    from gnsslib_tpu_torch.io.gn3s import Gn3sFrontend
    from gnsslib_tpu_torch.io.formats import unpack_gn3s_v2_aligned
    monkeypatch.setenv("MOCK_GN3S_PID", "0x0b39")
    monkeypatch.setenv("MOCK_GN3S_V2_SHIFT", shift)
    spec = FrontendSpec(fend=FrontendType.GN3SV2, f_cf=1.57542e9,
                        f_sf=8.1838e6, f_if=38400.0, dtype=DType.IQ)
    with Gn3sFrontend(spec, lib=gn3s_lib) as fe:
        assert fe.version == 2
        n = 4096
        x = fe.read(0, n)
        raw = _lcg_bytes(2 * n + 1)
        if shift == "1":                          # bit1 cleared everywhere
            raw = (raw & ~np.uint8(0x02))[1:]     # one-byte realignment
        else:
            raw = (raw | np.uint8(0x02))[:2 * n]
        np.testing.assert_array_equal(
            x, unpack_gn3s_v2_aligned(raw.tobytes()))


def test_gn3s_wrong_generation(gn3s_lib, monkeypatch):
    from gnsslib_tpu_torch.io.gn3s import Gn3sFrontend
    monkeypatch.setenv("MOCK_GN3S_PID", "0x0b39")   # a v2 dongle
    spec = FrontendSpec(fend=FrontendType.GN3SV3, f_cf=1.57542e9,
                        f_sf=16.368e6, f_if=4.092e6, dtype=DType.REAL)
    with pytest.raises(OSError, match="GN3SV2 is found"):
        Gn3sFrontend(spec, lib=gn3s_lib)


def test_cli_live_rtlsdr_end_to_end(tmp_path_factory):
    """`TYPE=RTLSDR` in the INI runs the in-process ctypes binding as
    the capture source (the reference's rcvinit dispatch, sdrrcv.c:60):
    mock vendor library replays a synthesized L1CA capture in real time;
    the receiver must acquire and track from the LIVE ring.  The CLI runs
    in its own process (``python -m gnsslib_tpu_torch``), as a user
    starts it."""
    from gnsslib_tpu_torch import sim

    lib = _build(tmp_path_factory, "rtlsdr")
    tmp = tmp_path_factory.mktemp("clilive")
    f_sf, f_if, prn = 2.046e6, 0.0, 7
    ch = sim.SimChannel(prn=prn, doppler=1200.0, code_phase=-333.0,
                        carr_phase=0.3)
    noise = sim.noise_std_for_cn0(1.0, 46.0, f_sf, DType.IQ)
    n = int(4.0 * f_sf)
    cap = tmp / "cap.bin"
    with open(cap, "wb") as f:
        for t0 in range(0, n, int(f_sf)):
            x = sim.synthesize([ch], f_sf, f_if, DType.IQ,
                               min(int(f_sf), n - t0), noise_std=noise,
                               seed=31 + t0, t0=t0)
            v = sim.quantize_int8(np.asarray(x), 16.0)
            (v.astype(np.int16) + 128).astype(np.uint8).tofile(f)
    fend = tmp / "fend.ini"
    fend.write_text(f"""[FEND]
TYPE     =RTLSDR
CF1      =1575.42e6
SF1      ={f_sf}
IF1      ={f_if}
DTYPE1   =2
[TRACK]
CORRN    =4
CORRD    =2
CORRP    =2
""")
    cfg = tmp / "rx.ini"
    cfg.write_text(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      =1
PRN      ={prn}
SYS      =1
CTYPE    =1
FTYPE    =1
[OUTPUT]
OUTMS    =400
RINEX    =0
""")
    env = dict(os.environ, GNSSLIB_RTLSDR_LIB=lib, MOCK_RTLSDR_FILE=str(cap),
               PYTHONPATH=REPO, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "gnsslib_tpu_torch", str(cfg),
                        "--device", "cpu", "--seconds", "3.0"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    text = r.stdout
    assert "live capture" in text
    assert "'acq'" in text and f" {prn}," in text   # acquired the PRN
    assert f"locked PRNs [{prn}]" in text
    assert "largest lag behind the producer" in text


def test_gn3s_overrun_is_fatal(gn3s_lib, monkeypatch):
    from gnsslib_tpu_torch.io.gn3s import Gn3sFrontend
    monkeypatch.setenv("MOCK_GN3S_PID", "0x0b3a")
    monkeypatch.setenv("MOCK_GN3S_OVERRUN_AFTER", "3")
    spec = FrontendSpec(fend=FrontendType.GN3SV3, f_cf=1.57542e9,
                        f_sf=16.368e6, f_if=4.092e6, dtype=DType.REAL)
    with Gn3sFrontend(spec, lib=gn3s_lib) as fe:
        deadline = time.monotonic() + 10.0
        while not fe.eof and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fe.eof
        assert fe.usb_overrun                     # sdrrcv.c:344-348
        assert fe.nsamples == 3 * 16384           # transfers before it


def test_cli_live_library_missing_exits_nonzero(tmp_path, monkeypatch,
                                                capsys):
    """A live binding whose vendor library does not load ends the CLI
    with exit code 1 and the loader's error, before any receiver runs."""
    from gnsslib_tpu_torch.io import rtlsdr
    from gnsslib_tpu_torch.runtime.cli import main as cli_main
    fend = tmp_path / "fend.ini"
    fend.write_text("[FEND]\nTYPE     =RTLSDR\nCF1      =1575.42e6\n"
                    "SF1      =2.046e6\nIF1      =0.0\nDTYPE1   =2\n")
    cfg = tmp_path / "rx.ini"
    cfg.write_text(f"[RCV]\nFENDCONF ={fend}\n[CHANNEL]\nNCH      =1\n"
                   "PRN      =7\nSYS      =1\nCTYPE    =1\nFTYPE    =1\n"
                   "[OUTPUT]\nRINEX    =0\n")
    monkeypatch.setenv("GNSSLIB_RTLSDR_LIB", str(tmp_path / "none.so"))
    monkeypatch.setattr(rtlsdr.ctypes.util, "find_library", lambda n: None)
    monkeypatch.setattr(rtlsdr, "_load_library", lambda path=None: (
        _ for _ in ()).throw(OSError("librtlsdr not found")))
    assert cli_main([str(cfg), "--device", "cpu"]) == 1
    assert "error: live front end: librtlsdr not found" in \
        capsys.readouterr().err
