"""The port's in-process RTL-SDR binding (io/rtlsdr.py) against the
repo's mock librtlsdr (tools/mock_rtlsdr.c, built with gcc into the
test's temporary directory), the counterpart of the JAX package's
tests/test_rtlsdr_binding.py: the configuration sequence of
rtlsdr_initconf, the mandatory endpoint reset, async-callback transfers
into the sample ring, and the u8 -> float decode.  (Kept apart from
tests/test_torch_live_bindings.py: see its docstring.)"""
import ctypes
import os
import subprocess

import numpy as np
import pytest

from gnsslib_tpu_torch.constants import DType, FrontendType
from gnsslib_tpu_torch.io.frontend import FrontendSpec

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


@pytest.fixture(scope="module")
def rtlsdr_lib(tmp_path_factory):
    return _build(tmp_path_factory, "rtlsdr")


def test_rtlsdr_binding_configures_and_streams(rtlsdr_lib):
    from gnsslib_tpu_torch.io.rtlsdr import RtlSdrFrontend
    from gnsslib_tpu_torch.io.formats import unpack_rtlsdr
    spec = FrontendSpec(fend=FrontendType.RTLSDR, f_cf=1.57542e9,
                        f_sf=2.048e6, f_if=0.0, dtype=DType.IQ,
                        ppmerr=25.0)
    with RtlSdrFrontend(spec, device=0, gain=40.2, lib=rtlsdr_lib) as fe:
        # the programming sequence of rtlsdr_initconf, observed by the
        # mock's recorders
        m = ctypes.CDLL(rtlsdr_lib)
        m.mock_get_rate.restype = ctypes.c_uint32
        m.mock_get_freq.restype = ctypes.c_uint32
        assert m.mock_get_rate() == 2048000
        assert m.mock_get_freq() == 1575420000
        assert m.mock_get_gain_mode() == 1       # manual (gain given)
        assert m.mock_get_gain() == 402          # tenths of dB
        assert m.mock_get_ppm() == 25
        assert m.mock_get_reset() == 1           # mandatory reset_buffer

        n = 8192
        x = fe.read(0, n)                        # blocks until produced
        assert x.shape == (n, 2)
        # byte-exact delivery through callback + ring: same LCG stream,
        # same u8 -> char decode as the reference (rtlsdr.c:136-143)
        expect = unpack_rtlsdr(_lcg_bytes(2 * n).tobytes())
        np.testing.assert_array_equal(x, expect)
        assert fe.overruns == 0
        assert fe.nsamples >= n
    # closed: cancel_async ended the grabber, stream marked EOF
    assert fe.eof


def test_rtlsdr_binding_autogain_default(rtlsdr_lib):
    from gnsslib_tpu_torch.io.rtlsdr import RtlSdrFrontend
    spec = FrontendSpec(fend=FrontendType.RTLSDR, f_cf=1.57542e9,
                        f_sf=2.048e6, f_if=0.0, dtype=DType.IQ)
    with RtlSdrFrontend(spec, lib=rtlsdr_lib) as fe:
        m = ctypes.CDLL(rtlsdr_lib)
        assert m.mock_get_gain_mode() == 0       # autogain (rtlsdr.c:87)
        fe.read(0, 256)


def test_rtlsdr_binding_rejects_bad_rate(rtlsdr_lib):
    from gnsslib_tpu_torch.io.rtlsdr import RtlSdrFrontend
    spec = FrontendSpec(fend=FrontendType.RTLSDR, f_cf=1.57542e9,
                        f_sf=16.368e6, f_if=0.0, dtype=DType.IQ)
    with pytest.raises(OSError, match="set_sample_rate"):
        RtlSdrFrontend(spec, lib=rtlsdr_lib)


def test_rtlsdr_binding_requires_iq(rtlsdr_lib):
    from gnsslib_tpu_torch.io.rtlsdr import RtlSdrFrontend
    spec = FrontendSpec(fend=FrontendType.RTLSDR, f_cf=1.57542e9,
                        f_sf=2.048e6, f_if=0.0, dtype=DType.REAL)
    with pytest.raises(ValueError):
        RtlSdrFrontend(spec, lib=rtlsdr_lib)


def test_rtlsdr_missing_library_message():
    from gnsslib_tpu_torch.io.rtlsdr import _load_library
    env = os.environ.pop("GNSSLIB_RTLSDR_LIB", None)
    try:
        with pytest.raises(OSError, match="ProcessFrontend"):
            _load_library("/nonexistent/librtlsdr.so")
    finally:
        if env is not None:
            os.environ["GNSSLIB_RTLSDR_LIB"] = env
