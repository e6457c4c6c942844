"""The port's live path: a grabber process -> host ring -> live device
cache -> ``run_live``, counterparts of the JAX package's
``tests/test_live.py``.

A pacer process (the "vendor binary") replays a synthesized capture on
its stdout; the port's receiver streams it through ``ProcessFrontend``
and must give the same events, epochs and pseudoranges, bit for bit, as
its own file replay of the same bytes (``run_seconds``), as one
:class:`Receiver` and as a :class:`MultiReceiver` of two channel groups
(GPS at a 10-period loop, an SBAS channel at 2) sharing one live cache.
Also: overruns are
detected (the ring, and the live cache's window), EOF serves the tail,
the ``rtl_sdr`` argv contract, the live cache against the file cache,
and the port's ``SampleRing``/``ring_read`` against the JAX package's on
one chunk stream."""
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from gnsslib_tpu.constants import DType as JaxDType
from gnsslib_tpu.constants import FrontendType as JaxFrontendType
from gnsslib_tpu.io import live as jax_live
from gnsslib_tpu.io.frontend import FrontendSpec as JaxSpec
from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.constants import CodeType, DType, FrontendType
from gnsslib_tpu_torch.io import ProcessFrontend, StreamOverrun
from gnsslib_tpu_torch.io import live as torch_live
from gnsslib_tpu_torch.io.devcache import DeviceBlockCache, LiveBlockCache
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.runtime.config import ChannelConfig, ReceiverConfig
from gnsslib_tpu_torch.runtime.receiver import MultiReceiver, build_receiver
from gnsslib_tpu_torch.track.state import TrackConfig

torch.set_num_threads(2)

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
SECONDS = 16.0
SPEC = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                    f_if=F_IF, dtype=DType.REAL)

PACER = textwrap.dedent("""\
    import sys, time
    path, bps, rate = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
    chunk = 65536
    out = sys.stdout.buffer
    with open(path, 'rb') as f:
        while True:
            d = f.read(chunk)
            if not d:
                break
            out.write(d)
            out.flush()
            time.sleep(chunk / bps / rate)
    """)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_live")
    chans = []
    for prn, d in ((3, 300), (21, 1300)):
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=3)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    path = tmp / "live.bin"
    with open(path, "wb") as f:
        step = int(F_SF)
        for t0 in range(0, n, step):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=1000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    pacer = tmp / "pacer.py"
    pacer.write_text(PACER)
    return str(path), str(pacer)


def _pacer_argv(pacer, path, rate_x):
    # the "vendor binary": replays the capture on stdout at rate_x real
    # time (int8 real sampling: 1 byte/sample)
    return [sys.executable, pacer, path, str(int(F_SF)), str(rate_x)]


def _cfg(path, groups):
    """GPS PRNs 3 and 21 (one group), and the absent SBAS PRN 129 (two)."""
    sbas = [ChannelConfig(prn=129, ctype=CodeType.L1SBAS, sys=8)]
    return ReceiverConfig(
        channels=[ChannelConfig(prn=3), ChannelConfig(prn=21)]
        + (sbas if groups == "two" else []),
        fends=[SPEC], files=[path],
        track=TrackConfig(corrn=4, corrd=2, corrp=2), outms=400,
        rinex=False)


def _outputs(rx, run):
    """Run ``rx`` -> (summary, events, epochs as (prn, tow, P, L, D, S))."""
    epochs = []
    emit = rx.hub.emit_epochs

    def record(inputs):
        out = emit(inputs)
        epochs.extend(out)
        return out
    rx.hub.emit_epochs = record
    s = run()
    rx.close()
    return s, rx.events, [[(o.prn, o.tow, o.P, o.L, o.D, o.S) for o in e]
                          for e in epochs]


@pytest.mark.parametrize("groups", ["one", "two"])
def test_live_equals_file_replay(capture, groups):
    """The live stream through ProcessFrontend gives the file replay's
    blocks, events, epochs and pseudoranges bit for bit, with no overrun;
    two groups read one live cache."""
    path, pacer = capture
    frx = build_receiver(_cfg(path, groups), FileFrontend(path, SPEC),
                         device="cpu")
    fs, fev, fep = _outputs(frx, frx.run_seconds)
    with ProcessFrontend(_pacer_argv(pacer, path, 8.0), SPEC,
                         ring_bytes=96 << 20) as fe:
        lrx = build_receiver(_cfg(path, groups), fe, device="cpu")
        parts = lrx.rx if groups == "two" else [lrx]
        assert isinstance(lrx, MultiReceiver) == (groups == "two")
        assert all(r.cache is parts[0].cache for r in parts)
        assert isinstance(parts[0].cache, LiveBlockCache)
        ls, lev, lep = _outputs(lrx, lrx.run_live)
        assert fe.overruns == 0 and fe.eof
    assert ls["blocks"] == fs["blocks"] and ls["seconds"] == fs["seconds"]
    assert sorted(ls["locked"]) == [3, 21] and ls["decoded"] == [3, 21]
    assert ls["epochs"] > 0
    assert lev == fev
    assert lep == fep
    assert ls["lag"] > 0.0


def test_live_overrun_detected(capture):
    """A consumer that falls a whole ring behind gets StreamOverrun (the
    reference's overrun -> stopflag, rtlsdr.c:25)."""
    path, pacer = capture
    with ProcessFrontend(_pacer_argv(pacer, path, 400.0), SPEC,
                         ring_bytes=1 << 16) as fe:
        # let the producer lap the tiny ring, then ask for old samples
        deadline = time.time() + 20.0
        while fe.nsamples * fe.bps < (1 << 18) and time.time() < deadline:
            time.sleep(0.05)
        with pytest.raises(StreamOverrun):
            fe.read(0, 4096)
        assert fe.overruns == 1
        # the live cache's first read of the same span fails the same way
        cache = LiveBlockCache(fe, device="cpu", capacity=1 << 16,
                               retain=0)
        with pytest.raises(StreamOverrun):
            cache.get(0, 4096)


def test_live_eof_serves_tail(capture):
    """After producer exit, ring content stays readable and reads past
    the end zero-pad instead of blocking forever."""
    with ProcessFrontend(
            [sys.executable, "-c",
             "import sys; sys.stdout.buffer.write(bytes(range(1, 101)))"],
            SPEC, timeout_s=5.0) as fe:
        deadline = time.time() + 10.0
        while not fe.eof and time.time() < deadline:
            time.sleep(0.02)
        assert fe.eof
        x = fe.read(0, 120)
        assert x.shape == (120,)
        np.testing.assert_array_equal(x[:100], np.arange(1, 101))
        np.testing.assert_array_equal(x[100:], 0.0)
        # the live cache pads only past the end of the finished stream
        cache = LiveBlockCache(fe, device="cpu", capacity=256, retain=16)
        y = cache.get(-4, 124).numpy()
        np.testing.assert_array_equal(y[:4], 0.0)
        np.testing.assert_array_equal(y[4:104], np.arange(1, 101))
        np.testing.assert_array_equal(y[104:], 0.0)


def test_rtl_sdr_argv_contract():
    """The rtl_sdr constructor builds the vendor CLI from the spec the
    way rtlsdr_initconf programs the device in-process (frequency, rate,
    device index, gain, ppm; raw stream to stdout)."""
    spec = FrontendSpec(fend=FrontendType.RTLSDR, f_cf=1.57542e9,
                        f_sf=2.048e6, f_if=0.0, dtype=DType.IQ,
                        ppmerr=25.0)
    argv = ProcessFrontend.rtl_sdr_argv(spec, device=1, gain=40.2)
    assert argv == ["rtl_sdr", "-f", "1575420000", "-s", "2048000",
                    "-d", "1", "-g", "40.2", "-p", "25", "-"]


class _Growing:
    """A live front end over an array whose producer count the test
    moves (``nsamples``) and ends (``eof``); a read must not reach past
    what the producer wrote unless the stream has ended."""
    is_live = True

    def __init__(self, x, spec, nsamples=0):
        self.x, self.spec = x, spec
        self.nsamples, self.eof = nsamples, False
        self.reads = []

    def read(self, start, n):
        assert start + n <= self.nsamples or self.eof
        self.reads.append((start, n))
        out = np.zeros((n,) + self.x.shape[1:], np.float32)
        got = self.x[start:start + n]
        out[:len(got)] = got
        return out


@pytest.mark.parametrize("iq", [False, True], ids=["real", "iq"])
def test_live_cache_matches_file_cache(iq):
    """The live cache serves a growing stream block by block with the
    file cache's values: each sample is read from the front end once,
    never before the producer wrote it, a window that drops old samples
    keeps ``retain`` before each request, a request below the window
    raises StreamOverrun, and zeros pad only before sample 0 and past the
    end of the ended stream."""
    rng = np.random.default_rng(5)
    n = 50_000
    x = rng.integers(-128, 128, (n, 2) if iq else n).astype(np.float32)
    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                        f_if=0.0 if iq else F_IF,
                        dtype=DType.IQ if iq else DType.REAL)
    fe = _Growing(x, spec)
    ref = DeviceBlockCache(_Growing(x, spec, nsamples=n), device="cpu")
    cache = LiveBlockCache(fe, device="cpu", capacity=12_000, retain=3_000)
    span, step = 4_000, 3_000
    with pytest.raises(RuntimeError, match="producer has written"):
        cache.get(-500, span)
    starts = range(-500, n - span + 2_000, step)
    for start in starts:
        fe.nsamples = min(start + span, n)
        fe.eof = start + span > n
        got = cache.get(start, span)
        np.testing.assert_array_equal(got.numpy(), ref.get(start, span))
        # a second group at its own origin, up to ``retain`` earlier
        back = max(start - 2_500, -500)
        np.testing.assert_array_equal(cache.get(back, span).numpy(),
                                      ref.get(back, span))
    # each sample read once, in order, the last read past the stream's end
    assert fe.reads[0][0] == 0 and all(
        a + k == b for (a, k), (b, _) in zip(fe.reads, fe.reads[1:]))
    assert sum(k for _, k in fe.reads) == starts[-1] + span > n
    with pytest.raises(StreamOverrun):
        cache.get(0, span)


def test_ring_matches_jax_ring():
    """The port's SampleRing and ring_read return the JAX package's bytes
    and samples for one stream of chunks (wraparound splices, partial
    spans, the overrun of a lapped span)."""
    rng = np.random.default_rng(11)
    ring_bytes = 10_000
    rings = (torch_live.SampleRing(ring_bytes),
             jax_live.SampleRing(ring_bytes))
    specs = (FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                          f_sf=F_SF, f_if=0.0, dtype=DType.IQ),
             JaxSpec(fend=JaxFrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                     f_if=0.0, dtype=JaxDType.IQ))
    pos = 0
    for _ in range(40):
        chunk = rng.integers(0, 256, int(rng.integers(1, 3_000)),
                             dtype=np.uint8).tobytes()
        for r in rings:
            r.write(chunk)
        pos += len(chunk)
        b0 = int(rng.integers(max(0, pos - ring_bytes), pos))
        b1 = int(min(pos + 100, b0 + rng.integers(1, ring_bytes)))
        spans = [r.read_span(b0, b1, 0.0) for r in rings]
        assert spans[0] == spans[1] and len(spans[0]) == min(b1, pos) - b0
        s0 = (b0 + 1) // 2
        xs = [mod.ring_read(r, sp, 2, s0, 700, 0.0) for mod, r, sp in
              zip((torch_live, jax_live), rings, specs)]
        np.testing.assert_array_equal(xs[0], xs[1])
    for r in rings:
        with pytest.raises(Exception) as e:
            r.read_span(0, 10, 0.0)
        assert type(e.value).__name__ == "StreamOverrun"
        assert r.overruns == 1
    for r in rings:
        r.mark_eof()
    assert rings[0].read_span(pos - 5, pos + 5, 1.0) == \
        rings[1].read_span(pos - 5, pos + 5, 1.0)
