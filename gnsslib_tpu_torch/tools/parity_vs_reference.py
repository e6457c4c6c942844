"""Head-to-head parity: the reference C receiver against the port (port of
the JAX package's ``tools/parity_vs_reference.py``).

Builds the reference (``$GNSSLIB_REFERENCE/src`` with its RTKLIB subset)
with the shim headers in ``refshim/`` beside this file (fftw3f backed by a
Bluestein FFT, a minimal ka9q-fec viterbi27, a libusb stub: byte-for-byte
copies of the JAX package's), runs both receivers on the same synthesized
IF capture, and compares their RINEX observables.  The port's half
(:func:`run_mine`) is the port's CLI on the card (``--device cuda``, the
default) or on the CPU; the captures, INI files, parsers, scenarios and
gates are the JAX tool's, so the two tools' numbers compare.

Scenarios (:data:`SCENARIOS`): ``gps`` (2 satellites, 47 dB-Hz, 32 s at
4.092 Msps), ``weak`` (42 dB-Hz), ``ppm`` (+5 ppm of LO error through
``FILERTLSDR``'s ``PPMERR``, 2.048 Msps u8 I/Q), ``highdyn`` (a 10 Hz/s
Doppler ramp), ``glo`` (GPS + G1, 40 s), ``sbas`` (GPS + SBAS PRN 129 and
the NovAtel RAWSBASFRAME stream), ``fullenv`` (32 GPS channels at 16.368
Msps, 20 s) and ``fullenv_glo`` (26 GPS + 6 G1 in one 16.368 Msps stream,
30 s).  The two ``fullenv`` captures are cached in the temporary
directory under the JAX tool's names.

Usage:  python -m gnsslib_tpu_torch.tools.parity_vs_reference [--keep]
            [--scenario gps] [--device cuda|cpu]

Without a card (``--device cuda``) it exits 2 before any work; without the
reference sources it raises ``FileNotFoundError`` at its first step.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from . import no_card

# the reference tree: $GNSSLIB_REFERENCE, else ``reference`` in the home
# directory (the JAX tool's default for its user)
REF = os.environ.get("GNSSLIB_REFERENCE",
                     os.path.join(os.path.expanduser("~"), "reference"))
SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "refshim")

SDR_UNITS = ["sdrmain", "sdrcmn", "sdracq", "sdrcode", "sdrinit", "sdrnav",
             "sdrnav_gps", "sdrnav_glo", "sdrnav_sbs", "sdrout", "sdrplot",
             "sdrrcv", "sdrspec", "sdrtrk", "sdrsync"]
RTK_UNITS = ["rtkcmn", "rtcm", "rtcm2", "rtcm3", "rtcm3e", "rinex"]


def build_reference(workdir: str, patch_g1: bool = False,
                    patch_frtlsdr: bool = False,
                    fullenv: bool = False,
                    patch_bitsync: bool = False) -> str:
    src = os.path.join(REF, "src")
    if not os.path.isdir(src):
        raise FileNotFoundError(
            f"reference sources not found: {src} (set GNSSLIB_REFERENCE to "
            f"the reference tree)")
    rtk = os.path.join(REF, "lib", "RTKLIB", "src")
    rtl = os.path.join(src, "rcv", "rtlsdr")
    # -DRTLSDR enables the FILE-REPLAY twin FEND_FRTLSDR (the only front
    # end whose PPMERR/foffset path the reference wires, sdrinit.c:616);
    # the live USB symbols are satisfied by refshim/rtlsdrshim.c
    # -DENAGLO: reference fork bug #3 — neither bin/Makefile:17 nor the
    # CI workflow defines ENAGLO, so its RTKLIB compiles with NSATGLO=0
    # (rtklib.h:127-140), satno(SYS_GLO, slot) returns 0, and every
    # GLONASS observation/ephemeris is silently dropped at the RINEX/
    # RTCM output stage even when tracking and decode succeed.  Upstream
    # RTKLIB application makefiles enable ENAGLO; wire it the same way
    # (a build flag, not a source patch) so GLONASS parity is testable.
    inc = ["-I" + SHIM, "-I" + src, "-I" + rtk, "-I" + rtl, "-DRTLSDR",
           "-DENAGLO"]
    # FFTMTX serializes every FFT execute behind one mutex
    # (src/sdrcmn.c:136-148) because the reference plans inside
    # cpxfft — real FFTW only needs the lock around planning.  The shim
    # plans from immutable cached tables, so the full-envelope scenario
    # (32 concurrent cold-start searches) drops the flag and lets
    # channel threads FFT concurrently, as a real-FFTW build would.
    fftmtx = [] if fullenv else ["-DFFTMTX"]
    objs = []
    for name, base in ([(u, src) for u in SDR_UNITS]
                       + [(u, rtk) for u in RTK_UNITS]
                       + [("rtlsdr", rtl)]):
        cfile = os.path.join(base, name + ".c")
        if fullenv and name == "sdrinit":
            # at 16.368 Msps the shim FFT makes the reference's
            # compile-time ±7 kHz/71-bin cold-start grid (sdr.h:146-147)
            # take minutes of CPU the paced replay won't wait for; the
            # synthesized sky keeps every Doppler inside ±1.5 kHz, so a
            # patched COPY narrows the REFERENCE grid to ±2 kHz.  (The
            # port still searches its full ±7 kHz grid — only the
            # reference needs the allowance for its missing FFTW.)
            txt = open(cfile).read().replace(
                "    acq->hband=ACQHBAND;\n"
                "    acq->step=ACQSTEP;\n"
                "    acq->nfreq=2*(ACQHBAND/ACQSTEP)+1;",
                "    acq->hband=2000; /* PATCH: shim-FFT budget */\n"
                "    acq->step=ACQSTEP;\n"
                "    acq->nfreq=2*(2000/ACQSTEP)+1;")
            assert "shim-FFT budget" in txt, "sdrinit patch anchor moved"
            cfile = os.path.join(workdir, "sdrinit.c")
            open(cfile, "w").write(txt)
        if fullenv and name == "sdrrcv":
            # slow the paced file replay 3x (65536 B per 15 ms instead
            # of per 5 ms): the reference stops AT EOF (sdrrcv.c:486-489
            # sets stopflag on short read and every thread exits), so on
            # a 4-core host a 16.368 Msps 32-channel run must stay under
            # the replay rate or lose its tail mid-stream — equivalent to
            # replaying from a slower disk, and obs content (what parity
            # compares) is pacing-independent.
            txt = open(cfile).read().replace(
                "        file_pushtomembuf(); /* copy to membuffer */\n"
                "        sleepms(5);",
                "        file_pushtomembuf(); /* copy to membuffer */\n"
                "        sleepms(15); /* PATCH: 4-core replay budget */")
            assert "replay budget" in txt, "sdrrcv patch anchor moved"
            cfile = os.path.join(workdir, "sdrrcv.c")
            open(cfile, "w").write(txt)
        if patch_frtlsdr and name == "sdrinit":
            # reference bug: the FEND_FRTLSDR branch of initsdrch sets
            # foffset but never sdr->f_cf (sdrinit.c:616-617), leaving
            # f_cf=0 — the DLL carrier aiding then divides by zero
            # (sdrtrk.c:148: (carrfreq-f_if-foffset)/(f_cf/crate)) and
            # codefreq goes to -inf at the FIRST loop update, crashing
            # rescode.  Every FRTLSDR run of this fork dies this way;
            # patch a COPY so the ppm scenario can compare against a
            # working reference.
            txt = open(cfile).read().replace(
                "    } else if (sdrini.fend==FEND_FRTLSDR) {\n"
                "        sdr->foffset=f_cf*sdrini.rtlsdrppmerr*1e-6;",
                "    } else if (sdrini.fend==FEND_FRTLSDR) {\n"
                "        sdr->f_cf=f_cf; /* PATCH: fork bug, f_cf unset */\n"
                "        sdr->foffset=f_cf*sdrini.rtlsdrppmerr*1e-6;")
            cfile = os.path.join(workdir, "sdrinit.c")
            open(cfile, "w").write(txt)
        if patch_bitsync and name == "sdrnav":
            # reference fork bug #4: checksync's BeiDou NH20 secondary-
            # code branch is gated on PRN ALONE (sdrnav.c:203 "prn > 5";
            # upstream GNSS-SDRLIB also requires ctype==CTYPE_B1I, which
            # this fork stripped).  Every PRN>5 channel — all SBAS PRNs
            # (120-138) and most GPS PRNs — therefore syncs on a trivial
            # all-ones "overlay" whose |corr|==rate test latches a WRONG
            # bit phase whenever the first observed symbols share a
            # sign (~50% of runs); a mis-paired SBAS stream Viterbi-
            # decodes to garbage and never finds a preamble.  Patch a
            # COPY to route everything to the transition-voting branch,
            # as upstream does for every non-B1I signal.
            txt = open(cfile).read().replace(
                "    if ( nav->sdreph.prn> 5) {",
                "    if (0) { /* PATCH: fork bug #4 — NH20 branch "
                "gated on prn alone; fork has no B1I ctype */")
            assert "fork bug #4" in txt, "sdrnav patch anchor moved"
            cfile = os.path.join(workdir, "sdrnav.c")
            open(cfile, "w").write(txt)
        if patch_bitsync and name == "sdrsync":
            # reference fork bug #5 (same genre as #3's dead GLONASS
            # output): the sync thread admits channels by
            # nav.sdreph.eph.week — the GPS broadcast-eph field that
            # SBAS decode never fills (it sets week_gpst,
            # sdrnav_sbs.c:137) — so a tracked, decoded SBAS channel
            # NEVER contributes observables.  obs[i].week itself reads
            # week_gpst (sdrsync.c:111); patch the gate to the same
            # field so the SBAS chain's observables are comparable.
            txt = open(cfile).read().replace(
                "            if (sdrch[i].nav.flagdec&&"
                "sdrch[i].nav.sdreph.eph.week!=0) {",
                "            if (sdrch[i].nav.flagdec&&"
                "sdrch[i].nav.sdreph.week_gpst!=0) { "
                "/* PATCH: fork bug #5 — SBAS sets week_gpst only */")
            assert "fork bug #5" in txt, "sdrsync patch anchor moved"
            cfile = os.path.join(workdir, "sdrsync.c")
            open(cfile, "w").write(txt)
        if patch_g1 and name == "sdrcode":
            # this fork's gencode dispatch lacks the CTYPE_G1 case
            # (src/sdrcode.c:523-539, SURVEY.md §2.1 quirk); wire it the
            # way upstream GNSS-SDRLIB does — in a patched COPY
            txt = open(cfile).read().replace(
                "    case CTYPE_L1SBAS: return gencode_L1CA(prn,len,crate);",
                "    case CTYPE_L1SBAS: return gencode_L1CA(prn,len,crate);"
                "\n    case CTYPE_G1    : return gencode_G1G2(len,crate);")
            cfile = os.path.join(workdir, "sdrcode.c")
            open(cfile, "w").write(txt)
        obj = os.path.join(workdir, name + ".o")
        subprocess.run(["gcc", "-c", "-O2", "-w", *fftmtx, *inc,
                        cfile, "-o", obj],
                       check=True, capture_output=True)
        objs.append(obj)
    for shim in ("fftshim.c", "fecshim.c", "rtlsdrshim.c"):
        obj = os.path.join(workdir, shim.replace(".c", ".o"))
        subprocess.run(["gcc", "-c", "-O2", "-I" + SHIM,
                        os.path.join(SHIM, shim), "-o", obj],
                       check=True, capture_output=True)
        objs.append(obj)
    exe = os.path.join(workdir, "erlang-gnss")
    subprocess.run(["gcc", "-o", exe, *objs, "-lm", "-lpthread"],
                   check=True, capture_output=True)
    return exe


def glo_channels() -> list:
    """The two SimChannels of :func:`synthesize_glo` (GPS PRN 5, G1 fcn
    +1)."""
    from .. import sim
    from ..constants import CodeType, FREQ1_GLO, DFRQ1_GLO
    from ..gtime import gpst2time
    F_SF, TOWREF = 4.092e6, 352804.0
    eph = sim.example_eph(prn=5, week=2200, toe_tow=TOWREF + 8.0)
    frames = sim.lnav_bit_stream(eph, TOWREF + 8.0, nframes=7)
    pad = np.concatenate([np.tile([1, -1], 199), [1, 1]]).astype(np.int8)
    gps = sim.SimChannel(prn=5, doppler=600.0,
                         code_phase=-400 * 1.023e6 / F_SF, carr_phase=0.2,
                         nav_bits=np.concatenate([pad, frames]))
    glo_bits = sim.g1_symbol_stream(gpst2time(2200, TOWREF - 16.0),
                                    nframes=3, iode=44, slot=13)[1600:]
    glo = sim.SimChannel(prn=1, ctype=CodeType.G1, doppler=-1400.0,
                         code_phase=-900 * 0.511e6 / F_SF, carr_phase=0.7,
                         nav_bits=glo_bits, nav_ms=10.0,
                         f_cf=FREQ1_GLO + DFRQ1_GLO,
                         foffset=DFRQ1_GLO)
    return [gps, glo]


def synthesize_glo(workdir: str, seconds: float = 40.0) -> str:
    """GPS PRN5 + GLONASS fcn+1/slot 13 mixed capture (staged config 4).

    Timing layout: receivers bit-sync several seconds into a cold
    capture (the reference's staggered thread start + ACQSLEEP retry
    puts its GLONASS channel ~6 s in), so a GLONASS stream that opens
    at string 1 loses the opening strings and the full geph (strings
    1-5) only completes in the NEXT 30 s frame — past short captures.
    The stream therefore starts mid-frame, at string 9, so strings 1-5
    of the next frame land at t=14-24 s, comfortably after both
    receivers' bit sync.  GLONASS frames must start on 30 s boundaries
    of GLONASS (UTC+3h) time — the tk field has 30 s resolution —
    which in GPST is tow = 18 mod 30 (18 leap seconds).  With the
    capture starting at tow 352804: the sliced frame started 16 s
    earlier at 352788 = 18 (mod 30), and the GPS subframe grid starts
    at 352812 (pad 8 s, multiple of 6).  Both systems' nav times stay
    physically consistent with ONE stream clock."""
    from .. import sim
    from ..constants import DType
    F_SF, F_IF = 4.092e6, 1.023e6
    chans = glo_channels()
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    path = os.path.join(workdir, "sim.bin")
    with open(path, "wb") as f:
        for t0 in range(0, int(seconds * F_SF), int(F_SF)):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               int(F_SF), noise_std=noise,
                               seed=4000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    return path


def sbas_messages(seconds: float = 30.0) -> list:
    """The SBAS messages of :func:`synthesize_sbas`, one per second (250
    ±1 bits each): MT12 with GPS time every 3rd message, MT63 filler with
    random payloads."""
    from ..nav.sbas import encode_sbas_message
    TOW0 = 352800.0
    preambles = [0x53, 0x9A, 0xC6]
    rng = np.random.default_rng(12)
    msgs = []
    for k in range(int(seconds) + 2):
        if k % 3 == 0:
            payload = np.zeros(212, np.int64)
            tow_field = int(TOW0) + k + 2
            for i in range(20):
                payload[107 - 14 + i] = (tow_field >> (19 - i)) & 1
            wk = (2200 - 1024) & 0x3FF
            for i in range(10):
                payload[127 - 14 + i] = (wk >> (9 - i)) & 1
            msgs.append(encode_sbas_message(12, payload,
                                            preambles[k % 3]))
        else:
            msgs.append(encode_sbas_message(63, rng.integers(0, 2, 212),
                                            preambles[k % 3]))
    return msgs


def sbas_symbols(seconds: float = 30.0) -> np.ndarray:
    """The SBAS channel's 500 sps symbol stream of :func:`synthesize_sbas`
    (±1 int8): :func:`sbas_messages` rate-1/2 K=7 encoded."""
    from ..nav.viterbi import conv27_encode
    bits01 = ((1 - np.concatenate(sbas_messages(seconds))) // 2
              ).astype(np.int64)
    sym = conv27_encode(bits01)
    return np.where(sym == 0, 1, -1).astype(np.int8)


def sbas_channels(seconds: float = 30.0) -> list:
    """The two SimChannels of :func:`synthesize_sbas` (GPS PRN 5 first)."""
    from .. import sim
    from ..constants import CodeType
    F_SF, TOW0 = 4.092e6, 352800.0
    eph = sim.example_eph(prn=5, week=2200, toe_tow=TOW0)
    frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=6)
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    gps = sim.SimChannel(prn=5, doppler=600.0,
                         code_phase=-400 * 1.023e6 / F_SF, carr_phase=0.2,
                         nav_bits=np.concatenate([pad, frames]))
    sbas = sim.SimChannel(prn=129, ctype=CodeType.L1SBAS, doppler=-900.0,
                          code_phase=-170.0, carr_phase=0.9, nav_ms=2.0,
                          nav_bits=sbas_symbols(seconds))
    return [gps, sbas]


def synthesize_sbas(workdir: str, seconds: float = 30.0) -> str:
    """GPS PRN5 + SBAS PRN129 capture (the sdrnav_sbs.c signal chain).

    The SBAS stream is built with the port's bit-true encoder:
    250 bps messages (MT12 with GPS time every 3rd message, MT63 filler
    with random payloads — unique, so frames can be matched by payload
    across receivers), rate-1/2 K=7 convolutionally encoded to 500 sps
    symbols (nav_ms=2).  Channel ORDER matters for the reference: its
    week borrow reads sdrch[nch-2] (src/sdrnav_sbs.c:124-127), so the
    GPS channel must be first of the two."""
    from .. import sim
    from ..constants import DType
    F_SF, F_IF = 4.092e6, 1.023e6
    chans = sbas_channels(seconds)
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    path = os.path.join(workdir, "sim.bin")
    with open(path, "wb") as f:
        for t0 in range(0, int(seconds * F_SF), int(F_SF)):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               int(F_SF), noise_std=noise,
                               seed=8000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    return path


class _SbasTcpReader:
    """Client thread capturing one receiver's NovAtel SBAS TCP stream.

    Connect-retries until the receiver's server accepts (both receivers
    open their servers at startup, before any signal processing), then
    reads until the server closes at receiver exit."""

    def __init__(self, port: int):
        import threading
        self.port = port
        self.data = b""
        self.stop = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        import socket
        import time as _t
        s = None
        deadline = _t.time() + 120.0
        while _t.time() < deadline and not self.stop:
            try:
                s = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=1.0)
                break
            except OSError:
                _t.sleep(0.25)
        if s is None:
            return
        s.settimeout(2.0)
        while True:
            try:
                b = s.recv(4096)
            except OSError:
                if self.stop:
                    break
                continue
            if not b:
                break
            self.data += b
        s.close()

    def finish(self) -> bytes:
        self.stop = True
        self._t.join(timeout=10.0)
        return self.data


def parse_novatel_sbas(data: bytes) -> list:
    """NovAtel OEM6 RAWSBASFRAME stream -> [(payload29, id, tow), ...]."""
    out = []
    i = 0
    while True:
        j = data.find(b"\xaa\x44\x12", i)
        if j < 0 or j + 80 > len(data):
            break
        frame = data[j:j + 80]
        mid = frame[4] | (frame[5] << 8)
        if mid != 973:
            i = j + 1
            continue
        out.append((bytes(frame[28 + 12:28 + 12 + 29]),
                    frame[28 + 8],
                    int.from_bytes(frame[16:20], "little") / 1000.0))
        i = j + 80
    return out


# the JAX tool's cache names, in the temporary directory
FULLENV_CACHE = os.path.join(tempfile.gettempdir(),
                             "gnsslib_parity_fullenv_16m.bin")
FULLENVGLO_CACHE = os.path.join(tempfile.gettempdir(),
                                "gnsslib_parity_fullenvglo_16m.bin")
# fullenv_glo sky: 26 GPS PRNs + 6 GLONASS FDMA channels (the STEREO
# L1+G1 capture class, test/testdata_download_link.txt:13-16, at the
# post-processing envelope).  fcn is capped at +6 so the G1 carrier
# (IF 4.092 MHz + fcn*0.5625 MHz) stays under the 8.184 MHz
# real-sampling Nyquist of the 16.368 Msps envelope.
FULLENVGLO_NGPS = 26
FULLENVGLO_FCNS = (1, 2, 3, 4, 5, 6)


def _fullenv_chans(glo: bool = False):
    from .. import sim
    from ..constants import CodeType, DFRQ1_GLO, FREQ1_GLO
    from ..gtime import gpst2time
    chans = []
    ngps = FULLENVGLO_NGPS if glo else 32
    # mixed-system timing layout (see synthesize_glo): stream starts at
    # tow 352804 so the mid-frame GLONASS slice stays on the 30 s UTC
    # frame grid while the GPS subframe grid starts at 352812 (pad 8 s)
    TOW0 = 352804.0 if glo else 352800.0
    pad_pairs = 199 if glo else 149
    gps_t0 = TOW0 + (8.0 if glo else 6.0)
    for prn in range(1, ngps + 1):
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, gps_t0, nframes=4)
        pad = np.concatenate([np.tile([1, -1], pad_pairs),
                              [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=250.0 * (prn % 13) - 1500.0,
            code_phase=97.0 * prn, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    if glo:
        for i, fcn in enumerate(FULLENVGLO_FCNS):
            bits = sim.g1_symbol_stream(gpst2time(2200, TOW0 - 16.0),
                                        nframes=2, iode=40 + i,
                                        slot=11 + i)[1600:]
            chans.append(sim.SimChannel(
                prn=fcn, ctype=CodeType.G1,
                doppler=420.0 * i - 1100.0,
                code_phase=61.0 * (i + 1), carr_phase=0.13 * i,
                nav_bits=bits, nav_ms=10.0,
                f_cf=FREQ1_GLO + DFRQ1_GLO * fcn,
                foffset=DFRQ1_GLO * fcn))
    return chans


def fullenv_levels(glo: bool = False) -> tuple:
    """(noise sigma, int8 scale) of the ``fullenv`` captures: 46 dB-Hz,
    the scale clear of clipping for noise + the 32-signal composite."""
    from .. import sim
    from ..constants import DType
    noise = sim.noise_std_for_cn0(1.0, 46.0, 16.368e6, DType.REAL)
    return noise, 110.0 / (3.0 * np.sqrt(noise ** 2 + 32.0 / 2.0))


def _fullenv_chunk(args):
    t0, count, noise, scale, glo = args
    from .. import sim
    from ..constants import DType
    x = sim.synthesize(_fullenv_chans(glo), 16.368e6, 4.092e6, DType.REAL,
                       count, noise_std=noise, seed=5000 + t0, t0=t0)
    return t0, sim.quantize_int8(x, scale)


def synthesize_fullenv(seconds: float = 20.0, glo: bool = False) -> str:
    """The reference's REAL post-processing envelope
    (frontend/iffile.ini:6-8 + bin/gnss-sdrcli.ini NCH=32): 16.368 Msps
    real-sampled IF at 4.092 MHz, int8, all 32 channels present with
    live nav streams — the many-satellite epoch-alignment case neither
    implementation sees in the small scenarios.  ``glo=True`` swaps 6
    GPS channels for GLONASS FDMA signals (and extends the capture so
    the slower 5-string geph decode contributes observables).  Cached in
    the temporary directory (~8-11 min on 3 CPU workers to synthesize
    once; 327-491 MB)."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing
    cache = FULLENVGLO_CACHE if glo else FULLENV_CACHE
    if os.path.exists(cache) and \
            os.path.getsize(cache) == int(seconds * 16.368e6):
        return cache
    f_sf = 16.368e6
    noise, scale = fullenv_levels(glo)
    n = int(seconds * f_sf)
    step = int(f_sf)
    jobs = [(t0, min(step, n - t0), noise, scale, glo)
            for t0 in range(0, n, step)]
    # private temp + atomic publish: two concurrent builders must not
    # interleave writes into one shared temp file
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache),
                               prefix="gnsslib_fullenv_")
    try:
        with os.fdopen(fd, "wb") as f, ProcessPoolExecutor(
                max_workers=3,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for t0, q in ex.map(_fullenv_chunk, jobs):
                q.tofile(f)
        os.replace(tmp, cache)
    finally:
        if os.path.exists(tmp):         # failed build: no stray temp
            os.unlink(tmp)
    return cache


def stress_channels(cn0: float = 47.0, ppm: float = 0.0,
                    doppler_rate: float = 0.0, rtl: bool = False) -> tuple:
    """:func:`synthesize`'s signal: (channels, f_sf, f_if, dtype, noise
    sigma, int8 scale)."""
    from .. import sim
    from ..constants import DType
    TOW0 = 352800.0
    if rtl:
        # RTL-SDR replay envelope (frontend/rtlsdr_L1.ini): 2.048 Msps u8
        # I/Q at zero IF — the only front end whose PPMERR/foffset path
        # the reference wires (sdrinit.c:616-617 gates on FEND_FRTLSDR)
        F_SF, F_IF, dtype = 2.048e6, 0.0, DType.IQ
    else:
        F_SF, F_IF, dtype = 4.092e6, 1.023e6, DType.REAL
    lo_off = ppm * 1e-6 * 1.57542e9      # reference sign (sdrinit.c:617)
    chans = []
    for prn, d in ((3, 300), (21, 1300)):
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=6)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            doppler_rate=doppler_rate, foffset=lo_off,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, cn0, F_SF, dtype)
    # int8 scale tied to the noise floor: a fixed scale CLIPS weak-signal
    # captures into hard limiting (at 42 dB-Hz sigma=11.4, x16 saturates
    # 66% of samples and acquisition dies in both receivers)
    scale = min(16.0, 110.0 / (3.0 * max(noise, 1e-9)))
    return chans, F_SF, F_IF, dtype, noise, scale


def synthesize(workdir: str, seconds: float = 32.0, cn0: float = 47.0,
               ppm: float = 0.0, doppler_rate: float = 0.0,
               rtl: bool = False) -> str:
    """2-satellite GPS L1CA capture with stress knobs:

    ``cn0``          — per-satellite C/N0 (weak-signal stress near ACQTH);
    ``ppm``          — receiver clock error: every carrier shifts by the
                       common-mode LO offset +ppm*1e-6*f_cf (the
                       reference's PPMERR/foffset sign and model,
                       src/sdrinit.c:616-617; FILERTLSDR replay);
    ``doppler_rate`` — Hz/s Doppler ramp on every satellite (high
                       dynamics stress through the FLL/PLL and the
                       carrier-aided DLL).
    """
    from .. import sim
    chans, F_SF, F_IF, dtype, noise, scale = stress_channels(
        cn0, ppm, doppler_rate, rtl)
    path = os.path.join(workdir, "sim.bin")
    with open(path, "wb") as f:
        for t0 in range(0, int(seconds * F_SF), int(F_SF)):
            x = sim.synthesize(chans, F_SF, F_IF, dtype, int(F_SF),
                               noise_std=noise, seed=1000 + t0, t0=t0)
            if rtl:
                sim.quantize_rtlsdr(x, scale).tofile(f)
            else:
                sim.quantize_int8(x, scale).tofile(f)
    return path


def write_configs(workdir: str, ifpath: str, ppm: float = 0.0,
                  rtl: bool = False):
    fend = os.path.join(workdir, "fend.ini")
    scen = getattr(write_configs, "scenario", "gps")
    if scen.startswith("fullenv"):
        # the reference's own iffile.ini envelope (frontend/iffile.ini:
        # 6-8 SF/IF/DTYPE, :29-48 correlator + loop bandwidths)
        fe_sec = f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      =16.368e6
IF1      =4.092e6
DTYPE1   =1
CF2      =0.0
SF2      =0.0
IF2      =0.0
DTYPE2   =0
FILE1    ={ifpath}
FILE2    =
PPMERR   =0
[TRACK]
CORRN    =6
CORRD    =3
CORRP    =6
DLLB1    =5.0
PLLB1    =30.0
FLLB1    =200.0
DLLB2    =1.0
PLLB2    =10.0
FLLB2    =50.0
"""
    elif rtl:
        # mirror frontend/rtlsdr_L1.ini (file-replay twin FILERTLSDR)
        fe_sec = f"""[FEND]
TYPE     =FILERTLSDR
CF1      =1575.42e6
SF1      =2.048e6
IF1      =0.0
DTYPE1   =2
CF2      =0.0
SF2      =0.0
IF2      =0.0
DTYPE2   =0
FILE1    ={ifpath}
FILE2    =
PPMERR   ={int(round(ppm))}
[TRACK]
CORRN    =4
CORRD    =1
CORRP    =1
DLLB1    =5.0
PLLB1    =30.0
FLLB1    =200.0
DLLB2    =2.0
PLLB2    =20.0
FLLB2    =50.0
"""
    else:
        fe_sec = f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      =4.092e6
IF1      =1.023e6
DTYPE1   =1
CF2      =0.0
SF2      =0.0
IF2      =0.0
DTYPE2   =0
FILE1    ={ifpath}
FILE2    =
PPMERR   ={ppm:g}
[TRACK]
CORRN    =4
CORRD    =2
CORRP    =2
DLLB1    =5.0
PLLB1    =30.0
FLLB1    =200.0
DLLB2    =1.0
PLLB2    =10.0
FLLB2    =50.0
"""
    open(fend, "w").write(fe_sec)
    if scen == "fullenv":
        nch = 32
        chdef = (",".join(str(p) for p in range(1, 33)),
                 ",".join(["1"] * 32), ",".join(["1"] * 32))
        ftdef = ",".join(["1"] * 32)
    elif scen == "fullenv_glo":
        # 26 GPS + 6 GLONASS; the reference reads the PRN field as the
        # FDMA frequency number for SYS=4 (sdrinit.c:613-615)
        ngps, fcns = FULLENVGLO_NGPS, FULLENVGLO_FCNS
        nch = ngps + len(fcns)
        chdef = (",".join([str(p) for p in range(1, ngps + 1)]
                          + [str(f) for f in fcns]),
                 ",".join(["1"] * ngps + ["4"] * len(fcns)),
                 ",".join(["1"] * ngps + ["20"] * len(fcns)))
        ftdef = ",".join(["1"] * nch)
    else:
        nch = 2
        chdef = (("5,1", "1,4", "1,20") if scen == "glo"
                 else ("5,129", "1,2", "1,27") if scen == "sbas"
                 else ("3,21", "1,1", "1,1"))
        ftdef = "1,1"
    sbas_on = 1 if scen == "sbas" else 0
    for tag, outdir in (("ref", "out_ref"), ("mine", "out_mine")):
        os.makedirs(os.path.join(workdir, outdir), exist_ok=True)
        open(os.path.join(workdir, f"cli_{tag}.ini"), "w").write(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      ={nch}
PRN      ={chdef[0]}
SYS      ={chdef[1]}
CTYPE    ={chdef[2]}
FTYPE    ={ftdef}
[PLOT]
ACQ      =0
TRK      =0
[OUTPUT]
OUTMS    =400
RINEX    =1
RTCM     =0
SBAS     ={sbas_on}
LOG      =0
RINEXPATH ={os.path.join(workdir, outdir)}
LOGPATH ={os.path.join(workdir, outdir)}
RTCMPORT =9999
SBASPORT ={SBAS_PORTS[tag]}
[SPECTRUM]
SPEC     =0
""")


SBAS_PORTS = {"ref": 9995, "mine": 9996}


def parse_obs(path: str) -> dict:
    out = {}
    cur = None
    for ln in open(path).read().splitlines():
        if ln.startswith(">"):
            f = ln.split()
            cur = float(f[4]) * 3600 + float(f[5]) * 60 + float(f[6])
        elif cur is not None and re.match(r"[GRS] ?\d", ln):
            prn = (ln[0], int(ln[1:3]))
            vals = []
            for k in range(4):
                s = ln[3 + 16 * k:3 + 16 * k + 14].strip()
                vals.append(float(s) if s else np.nan)
            out[(round(cur, 3), prn)] = vals
    return out


# stress scenarios (round-2: synthetic substitutes for the unreachable
# real captures, test/testdata_download_link.txt): signal knobs + the
# acceptance envelope each must meet.  "weak" sits ~2 dB above the
# acquisition threshold; "ppm" exercises the PPMERR/foffset clock-error
# path of both receivers; "highdyn" sweeps a 30 Hz/s Doppler ramp
# (~900 Hz over the run) through the FLL/PLL and carrier-aided DLL.
SCENARIOS = {
    "gps":     dict(knobs={}, p_rms=5.0, d_rms=0.3, n_common=20),
    "glo":     dict(knobs={}, p_rms=5.0, d_rms=0.3, n_common=20),
    "weak":    dict(knobs=dict(cn0=42.0), p_rms=10.0, d_rms=1.0,
                    n_common=15),
    "ppm":     dict(knobs=dict(ppm=5.0, rtl=True), p_rms=5.0, d_rms=0.5,
                    n_common=20),
    # 10 Hz/s is the strongest ramp the REFERENCE survives cleanly; at
    # 30 Hz/s it drops pseudoranges and slips TOW while this framework
    # tracks the full ramp (tests/test_highdyn.py asserts that against
    # sim truth)
    "highdyn": dict(knobs=dict(doppler_rate=10.0, cn0=45.0), p_rms=6.0,
                    d_rms=0.6, n_common=20),
    # the reference's REAL post-processing envelope: 16.368 Msps real
    # IF, all 32 configured channels live (frontend/iffile.ini:6-8,
    # bin/gnss-sdrcli.ini NCH=32) — exercises many-channel epoch
    # alignment both implementations otherwise only see at 2-3 sats
    "fullenv": dict(knobs={}, p_rms=5.0, d_rms=0.3, n_common=300),
    # mixed-system envelope (STEREO L1+G1 capture class): 26 GPS + 6
    # GLONASS channels in one 16.368 Msps stream; 30 s and a string-9
    # stream start (strings 1-5 at t=14-24, after both receivers' bit
    # sync) so the 5-string geph decode leaves GLONASS observables in
    # the epoch stream.  Adds the cross-system gate
    # p_isb (below): GPS and GLONASS pseudorange residuals must share
    # one receiver clock.
    "fullenv_glo": dict(knobs={}, p_rms=5.0, d_rms=0.3, n_common=250),
    # the sdrnav_sbs.c signal chain head-to-head (the last chain never
    # compared, VERDICT r4 missing #2): GPS + SBAS PRN129, the reference
    # running its real Viterbi path through the ka9q-fec shim.  Beyond
    # obs parity, both receivers' NovAtel RAWSBASFRAME TCP streams are
    # captured and the decoded 29-byte message payloads compared
    # (MT63 payloads are random -> unique -> frames match by content).
    "sbas":    dict(knobs={}, p_rms=5.0, d_rms=0.3, n_common=20),
}


def compare(ref: dict, mine: dict, scenario: str, sbas_ref=(),
            sbas_mine=()) -> dict:
    """The JAX tool's statistics of ``mine`` against ``ref`` (each
    :func:`parse_obs`'s dict; the SBAS scenario also each receiver's
    :func:`parse_novatel_sbas` frames), its printed lines and its gates:
    returns the statistics with ``ok``."""
    spec = SCENARIOS[scenario]
    common = sorted(set(ref) & set(mine))
    # drop pairs where either side has blank fields (RTKLIB prints a
    # zero/invalid pseudorange as blanks — the REFERENCE does this
    # when a channel's tow slips under stress; the port's output is
    # deterministic across runs, the run-to-run variance is reference
    # thread scheduling)
    finite = [k for k in common
              if np.isfinite(mine[k][:3]).all()
              and np.isfinite(ref[k][:3]).all()]
    nan_pairs = len(common) - len(finite)
    sbas_finite = []
    if scenario == "sbas":
        # the reference's SBAS tow anchor is BORROWED from the GPS
        # channel at decode time and marked "tentative" in its own
        # source (sdrnav_sbs.c:123-127) — its SBAS pseudoranges
        # carry ms-scale, drifting anchor error by design (observed
        # 4.8-7.2 km of wander), while the port anchors SBAS time from
        # MT12 + the preamble sample.  SBAS parity is therefore judged
        # on Doppler + decoded message bytes; pseudorange gates run on
        # the GPS subset.
        sbas_finite = [k for k in finite if k[1][0] == "S"]
        finite = [k for k in finite if k[1][0] != "S"]
    dP = np.array([mine[k][0] - ref[k][0] for k in finite])
    dD = np.array([mine[k][2] - ref[k][2] for k in finite])
    # robust inlier mask: a reference TOW slip shifts its pseudorange
    # by whole milliseconds (~300 km), and under many-channel load
    # its sync thread snapshots a channel mid-update, producing
    # single-epoch 30-90 Hz Doppler spikes correlated across PRNs
    # (the port's output is deterministic; the spikes revert to
    # <0.3 Hz agreement the very next epoch) — count both as
    # dropouts, not as parity error, and compare the agreeing epochs
    medP = float(np.median(dP))
    medD = float(np.median(dD))
    inl_p = np.abs(dP - medP) < 1000.0
    inl_d = np.abs(dD - medD) < 5.0
    inl = inl_p & inl_d
    outlier_frac = float(1.0 - inl.mean()) if len(dP) else 1.0
    # Doppler dropouts are bounded SEPARATELY and tighter: the gate
    # exists for the reference's single-epoch snapshot spikes (a few
    # epochs per run), and must not let a systematic Doppler
    # disagreement of the port's ride the generous TOW-slip allowance
    d_outlier_frac = (float((inl_p & ~inl_d).mean())
                      if len(dD) else 1.0)
    dPi = dP[inl]
    dDi = dD[inl]
    # a constant ALL-satellite pseudorange offset is a receiver-clock
    # definition difference (e.g. which channel anchors the common
    # epoch sample) — unobservable in positioning.  Compare clock-free:
    # remove the global mean when it is common-mode.
    dP_cf = dPi - dPi.mean()
    # carrier phase carries an arbitrary per-channel constant offset
    # in both implementations: compare per-satellite, mean-removed
    dL_parts = []
    fin_set = {k for k, m in zip(finite, inl) if m}
    for prn in {k[1] for k in fin_set}:
        v = np.array([mine[k][1] - ref[k][1] for k in fin_set
                      if k[1] == prn])
        dL_parts.append(v - v.mean())
    dL = (np.concatenate(dL_parts) if dL_parts
          else np.zeros(0))
    stats = dict(
        n_common=len(common), n_ref=len(ref), n_mine=len(mine),
        nan_pairs=nan_pairs, outlier_frac=outlier_frac,
        d_outlier_frac=d_outlier_frac,
        p_rms=float(np.sqrt((dPi ** 2).mean())) if len(dPi) else
        float("nan"),
        p_rms_clockfree=float(np.sqrt((dP_cf ** 2).mean()))
        if len(dPi) else float("nan"),
        p_mean=float(dPi.mean()) if len(dPi) else float("nan"),
        p_max=float(np.abs(dPi).max()) if len(dPi) else float("nan"),
        d_rms=float(np.sqrt((dDi ** 2).mean())) if len(dDi) else
        float("nan"),
        l_spread=float(dL.std()) if len(dL) else float("nan"))
    # cross-system alignment: both receivers form one clock, so the
    # GPS and GLONASS pseudorange residuals must agree up to the
    # common-mode offset — a per-system split would mean the two
    # implementations anchor the systems' epochs differently
    inl_keys = [k for k, m in zip(finite, inl) if m]
    dP_by_sys = {s: np.array([mine[k][0] - ref[k][0]
                              for k in inl_keys if k[1][0] == s])
                 for s in {k[1][0] for k in inl_keys}}
    stats["n_glo"] = int(len(dP_by_sys.get("R", ())))
    if "G" in dP_by_sys and "R" in dP_by_sys and stats["n_glo"]:
        stats["p_isb"] = float(np.median(dP_by_sys["R"])
                               - np.median(dP_by_sys["G"]))
    print(f"common obs: {stats['n_common']} "
          f"(ref {stats['n_ref']}, mine {stats['n_mine']}; "
          f"{nan_pairs} blank-field pairs, "
          f"outliers {outlier_frac:.0%})")
    print(f"pseudorange: rms {stats['p_rms']:.3f} m "
          f"(clock-free {stats['p_rms_clockfree']:.3f} m), "
          f"mean {stats['p_mean']:+.3f} m, max {stats['p_max']:.3f} m")
    print(f"doppler: rms {stats['d_rms']:.3f} Hz; "
          f"carrier spread {stats['l_spread']:.4f} cycles")
    if "p_isb" in stats:
        print(f"cross-system: {stats['n_glo']} GLONASS obs, "
              f"GPS-GLONASS residual split {stats['p_isb']:+.3f} m")
    ok = (stats["p_rms_clockfree"] < spec["p_rms"]
          and stats["d_rms"] < spec["d_rms"]
          and int(inl.sum()) >= spec["n_common"]
          and outlier_frac <= 0.30
          and d_outlier_frac <= 0.15
          and (nan_pairs + len(finite)) > 0
          and nan_pairs <= 0.3 * len(common))
    if scenario in ("glo", "fullenv_glo"):
        # mixed capture must actually land GLONASS observables, and
        # the two systems' residuals must share the receiver clock
        ok = ok and stats["n_glo"] >= (40 if scenario ==
                                       "fullenv_glo" else 5)
        ok = ok and abs(stats.get("p_isb", 1e9)) < spec["p_rms"]
    if scenario == "sbas":
        # decoded-message parity: the two NovAtel streams must agree
        # on the 29-byte payloads (unique per message, so content IS
        # identity); SBAS observables must land in both RINEX files
        # and agree on Doppler (pseudorange excluded — see the
        # sbas_finite split above: the reference's anchor is
        # tentative by its own source comment)
        ref_pl = {p: i for p, i, _ in sbas_ref}
        my_pl = {p: i for p, i, _ in sbas_mine}
        common_pl = set(ref_pl) & set(my_pl)
        stats["sbas_msgs_ref"] = len(sbas_ref)
        stats["sbas_msgs_mine"] = len(sbas_mine)
        stats["sbas_msgs_common"] = len(common_pl)
        stats["sbas_id_mismatch"] = sum(
            1 for p in common_pl if ref_pl[p] != my_pl[p])
        stats["n_sbs"] = len(sbas_finite)
        dDs = np.array([mine[k][2] - ref[k][2] for k in sbas_finite])
        dDs = dDs[np.abs(dDs - np.median(dDs)) < 5.0] if len(dDs) \
            else dDs
        stats["sbas_d_rms"] = (float(np.sqrt((dDs ** 2).mean()))
                               if len(dDs) else float("nan"))
        print(f"sbas: ref {len(sbas_ref)} / mine {len(sbas_mine)} "
              f"NovAtel frames, {len(common_pl)} common payloads "
              f"({stats['sbas_id_mismatch']} id mismatches); "
              f"{stats['n_sbs']} SBAS obs in the common set, "
              f"D rms {stats['sbas_d_rms']:.3f} Hz")
        ok = (ok and len(common_pl) >= 8
              and stats["sbas_id_mismatch"] == 0
              and stats["n_sbs"] >= 10
              and stats["sbas_d_rms"] < 0.5)
    print(f"PARITY[{scenario}] " + ("PASS" if ok else "FAIL"))
    stats["ok"] = ok
    return stats


def _obs_in(outdir: str) -> dict:
    return parse_obs(os.path.join(
        outdir, [p for p in os.listdir(outdir) if p.endswith(".obs")][0]))


def run_mine(workdir: str, ifpath: str, scenario: str,
             device: str = "cuda") -> tuple:
    """The port's half of a scenario: write the configs for ``ifpath``,
    run the port's CLI on ``cli_mine.ini`` (``python -m gnsslib_tpu_torch
    <ini> --quiet --device <device>``, in this process) and read its SBAS
    stream where the scenario has one -> (:func:`parse_obs` of its RINEX,
    :func:`parse_novatel_sbas` of its stream)."""
    from ..runtime import cli
    knobs = SCENARIOS[scenario]["knobs"]
    write_configs.scenario = scenario
    write_configs(workdir, ifpath, ppm=knobs.get("ppm", 0.0),
                  rtl=knobs.get("rtl", False))
    rdr = _SbasTcpReader(SBAS_PORTS["mine"]) if scenario == "sbas" else None
    try:
        rc = cli.main([os.path.join(workdir, "cli_mine.ini"), "--quiet",
                       "--device", device])
    finally:
        frames = parse_novatel_sbas(rdr.finish()) if rdr else []
    if rc != 0:
        raise RuntimeError(f"the port's CLI exited {rc} on {scenario}")
    return _obs_in(os.path.join(workdir, "out_mine")), frames


def run(keep: bool = False, scenario: str = "gps",
        device: str = "cuda") -> dict:
    workdir = tempfile.mkdtemp(prefix="parity_")
    spec = SCENARIOS[scenario]
    try:
        exe = build_reference(
            workdir, patch_g1=(scenario in ("glo", "fullenv_glo")),
            patch_frtlsdr=spec["knobs"].get("rtl", False),
            fullenv=scenario.startswith("fullenv"),
            patch_bitsync=(scenario == "sbas"))
        ifpath = (synthesize_glo(workdir) if scenario == "glo"
                  else synthesize_fullenv() if scenario == "fullenv"
                  else synthesize_fullenv(seconds=30.0, glo=True)
                  if scenario == "fullenv_glo"
                  else synthesize_sbas(workdir) if scenario == "sbas"
                  else synthesize(workdir, **spec["knobs"]))
        write_configs.scenario = scenario
        write_configs(workdir, ifpath,
                      ppm=spec["knobs"].get("ppm", 0.0),
                      rtl=spec["knobs"].get("rtl", False))

        # reference reads ./gnss-sdrcli.ini from CWD
        shutil.copy(os.path.join(workdir, "cli_ref.ini"),
                    os.path.join(workdir, "gnss-sdrcli.ini"))
        rdr_ref = (_SbasTcpReader(SBAS_PORTS["ref"])
                   if scenario == "sbas" else None)
        # keep the reference's stdin OPEN and silent: its keythread loops
        # on getchar() (src/sdrmain.c:59-80) and a closed/EOF stdin makes
        # it spin, printing "press 'q'..." millions of times — burning a
        # core the channel threads need and flooding the pipe (measured
        # 43M lines over one 30 s run).  An open pipe never written
        # blocks getchar and the thread sleeps.
        p = subprocess.Popen([exe], cwd=workdir, stdin=subprocess.PIPE,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        try:
            p.wait(timeout=1200)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        if p.returncode != 0:
            raise subprocess.CalledProcessError(p.returncode, exe)
        sbas_ref = (parse_novatel_sbas(rdr_ref.finish())
                    if rdr_ref is not None else [])
        mine, sbas_mine = run_mine(workdir, ifpath, scenario, device)
        ref = _obs_in(os.path.join(workdir, "out_ref"))
        return compare(ref, mine, scenario, sbas_ref, sbas_mine)
    finally:
        if keep:
            print("workdir:", workdir)
        else:
            shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch.tools.parity_vs_reference",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--scenario", choices=tuple(SCENARIOS), default="gps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if no_card(a.device, "parity_vs_reference"):
        return 2
    return 0 if run(keep=a.keep, scenario=a.scenario,
                    device=a.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
