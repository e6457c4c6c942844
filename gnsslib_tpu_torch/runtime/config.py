"""Receiver configuration: dataclasses + reference-compatible INI loader.

The port's own copy of :mod:`gnsslib_tpu.runtime.config`, which cannot be
imported without JAX (it reaches ``track.state``).  It reads the same
two-level INI layout (bin/gnss-sdrcli.ini + frontend/*.ini via FENDCONF;
reference readinifile, src/sdrinit.c:106-211) into the same fields, with
the port's :class:`TrackConfig`.

:func:`unported_options` is the one place that names a configured option
the port's receiver does not carry; the receiver would raise
``NotImplementedError`` for it instead of ignoring it.  Every option of
the INI is carried today.
"""
from __future__ import annotations

import configparser
import dataclasses
import os

from ..constants import (CodeType, DFRQ1_GLO, DType, FREQ1, FREQ1_GLO,
                         FrontendType, SYS_GPS)
from ..io.frontend import FrontendSpec
from ..track.state import LoopParams, TrackConfig


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    prn: int
    sys: int = SYS_GPS
    ctype: int = CodeType.L1CA
    ftype: int = 1

    @property
    def f_cf(self) -> float:
        """Carrier frequency used for code-Doppler aiding (initsdrch,
        src/sdrinit.c:607-621)."""
        if self.ctype == CodeType.G1:
            return FREQ1_GLO + self.prn * DFRQ1_GLO
        return FREQ1

    @property
    def foffset_fdma(self) -> float:
        """GLONASS FDMA offset added to the front-end IF (sdrinit.c:610)."""
        if self.ctype == CodeType.G1:
            return self.prn * DFRQ1_GLO
        return 0.0


@dataclasses.dataclass
class ReceiverConfig:
    channels: list[ChannelConfig]
    fends: list[FrontendSpec]            # index 0 = FTYPE1, 1 = FTYPE2
    files: list[str]                     # IF file per front end
    track: TrackConfig = dataclasses.field(default_factory=TrackConfig)
    outms: int = 400
    rinex: bool = True
    rtcm: bool = False
    sbas: bool = False
    log: bool = False
    rinexpath: str = "."
    logpath: str = "."
    rtcmport: int = 9999
    sbasport: int = 9997
    spec: bool = False
    ref_week: int = 2200
    relock: bool = False
    pullin_timeout: float = 8.0
    acqconfirm: bool = False
    spp: bool = False
    smooth: int = 0
    raim: float = 0.0
    hotstart: bool = False


def _get(cp, sec, key, default=None):
    try:
        v = cp.get(sec, key)
    except (configparser.NoSectionError, configparser.NoOptionError):
        return default
    v = v.split(";")[0].strip()          # inline ';' comments
    return v if v else default


def _getf(cp, sec, key, default=0.0):
    v = _get(cp, sec, key)
    return float(v) if v not in (None, "") else default


def _geti(cp, sec, key, default=0):
    v = _get(cp, sec, key)
    return int(float(v)) if v not in (None, "") else default


_FEND_NAMES = {
    "STEREO": FrontendType.STEREO, "GN3SV2": FrontendType.GN3SV2,
    "GN3SV3": FrontendType.GN3SV3, "RTLSDR": FrontendType.RTLSDR,
    "BLADERF": FrontendType.BLADERF, "FILESTEREO": FrontendType.FSTEREO,
    "FILEGN3SV2": FrontendType.FGN3SV2, "FILEGN3SV3": FrontendType.FGN3SV3,
    "FILERTLSDR": FrontendType.FRTLSDR, "FILEBLADERF": FrontendType.FBLADERF,
    "FILE": FrontendType.FILE,
}
LIVE_FENDS = (FrontendType.STEREO, FrontendType.GN3SV2, FrontendType.GN3SV3,
              FrontendType.RTLSDR, FrontendType.BLADERF)


def _read_cp(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(inline_comment_prefixes=(";",),
                                   strict=False)
    cp.optionxform = str.upper
    with open(path) as f:
        cp.read_string(f.read())
    return cp


def load_ini(path: str) -> ReceiverConfig:
    """Load a reference-style gnss-sdrcli.ini (+ its FENDCONF file)."""
    cp = _read_cp(path)
    base = os.path.dirname(os.path.abspath(path))

    nch = _geti(cp, "CHANNEL", "NCH", 0)

    def ints(key):
        return [int(x) for x in _get(cp, "CHANNEL", key, "").split(",")
                if x.strip()]
    prns, syss, ctys, ftys = (ints(k) for k in ("PRN", "SYS", "CTYPE",
                                                  "FTYPE"))
    chans = [ChannelConfig(prn=prns[i], sys=syss[i], ctype=ctys[i],
                           ftype=ftys[i]) for i in range(nch)]

    fendconf = _get(cp, "RCV", "FENDCONF", "")
    fpath = os.path.join(base, fendconf) if fendconf else None
    fends: list[FrontendSpec] = []
    files: list[str] = []
    track = TrackConfig()
    if fpath and os.path.exists(fpath):
        fc = _read_cp(fpath)
        fbase = os.path.dirname(os.path.abspath(fpath))
        ftype_name = (_get(fc, "FEND", "TYPE", "FILE") or "FILE").upper()
        fend = _FEND_NAMES.get(ftype_name, FrontendType.FILE)
        ppm = _getf(fc, "FEND", "PPMERR", 0.0)
        for k in (1, 2):
            sf = _getf(fc, "FEND", f"SF{k}", 0.0)
            if sf <= 0:
                continue
            fends.append(FrontendSpec(
                fend=fend, f_cf=_getf(fc, "FEND", f"CF{k}"),
                f_sf=sf, f_if=_getf(fc, "FEND", f"IF{k}"),
                dtype=_geti(fc, "FEND", f"DTYPE{k}", DType.REAL),
                ftype=k, ppmerr=ppm))
            fn = _get(fc, "FEND", f"FILE{k}", "") or ""
            files.append(os.path.join(fbase, fn) if fn and not
                         os.path.isabs(fn) else fn)
        track = TrackConfig(
            corrn=_geti(fc, "TRACK", "CORRN", 6),
            corrd=_geti(fc, "TRACK", "CORRD", 3),
            corrp=_geti(fc, "TRACK", "CORRP", 6),
            interp_replica=bool(_geti(fc, "TRACK", "INTERPREPLICA", 0)),
            prm1=LoopParams.from_bandwidths(
                _getf(fc, "TRACK", "DLLB1", 5.0),
                _getf(fc, "TRACK", "PLLB1", 30.0),
                _getf(fc, "TRACK", "FLLB1", 200.0)),
            prm2=LoopParams.from_bandwidths(
                _getf(fc, "TRACK", "DLLB2", 1.0),
                _getf(fc, "TRACK", "PLLB2", 10.0),
                _getf(fc, "TRACK", "FLLB2", 50.0)))

    return ReceiverConfig(
        channels=chans, fends=fends, files=files, track=track,
        outms=_geti(cp, "OUTPUT", "OUTMS", 400),
        rinex=bool(_geti(cp, "OUTPUT", "RINEX", 0)),
        rtcm=bool(_geti(cp, "OUTPUT", "RTCM", 0)),
        sbas=bool(_geti(cp, "OUTPUT", "SBAS", 0)),
        log=bool(_geti(cp, "OUTPUT", "LOG", 0)),
        rinexpath=_get(cp, "OUTPUT", "RINEXPATH", ".") or ".",
        logpath=_get(cp, "OUTPUT", "LOGPATH", ".") or ".",
        rtcmport=_geti(cp, "OUTPUT", "RTCMPORT", 9999),
        sbasport=_geti(cp, "OUTPUT", "SBASPORT", 9997),
        spec=bool(_geti(cp, "SPECTRUM", "SPEC", 0)),
        relock=bool(_geti(cp, "RCV", "RELOCK", 0)),
        pullin_timeout=_getf(cp, "RCV", "PULLINTMO", 8.0),
        acqconfirm=bool(_geti(cp, "RCV", "ACQCONFIRM", 0)),
        spp=bool(_geti(cp, "OUTPUT", "SPP", 0)),
        smooth=_geti(cp, "OUTPUT", "SMOOTH", 0),
        raim=_getf(cp, "OUTPUT", "RAIM", 0.0),
        hotstart=bool(_geti(cp, "RCV", "HOTSTART", 0)),
    )


def unported_options(cfg: ReceiverConfig) -> list[str]:
    """Configured options outside the port's receiver, by their INI names:
    none.  The receiver carries file-replay and live front ends, one or
    two RF paths, real or I/Q sampling; GPS L1CA, GLONASS G1 and SBAS
    channels; RINEX, RTCM, SBAS, SPP and track log output; relock, hot
    start and acquisition confirmation; and the SPEC diagnostics."""
    return []
