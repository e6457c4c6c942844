"""Ephemeris data model — RTKLIB eph_t / geph_t equivalents.

The reference embeds RTKLIB's structs in its channel state
(src/sdr.h:415-434); here they are plain dataclasses the RINEX/RTCM
writers consume.
"""
from __future__ import annotations

import dataclasses

from ..gtime import GTime


@dataclasses.dataclass
class Eph:
    """GPS/QZS broadcast ephemeris (RTKLIB eph_t)."""
    sat: int = 0
    iode: int = -1
    iodc: int = -1
    sva: int = 0
    svh: int = 0
    week: int = 0
    code: int = 0
    flag: int = 0
    toe: GTime = dataclasses.field(default_factory=GTime)
    toc: GTime = dataclasses.field(default_factory=GTime)
    ttr: GTime = dataclasses.field(default_factory=GTime)
    A: float = 0.0
    e: float = 0.0
    i0: float = 0.0
    OMG0: float = 0.0
    omg: float = 0.0
    M0: float = 0.0
    deln: float = 0.0
    OMGd: float = 0.0
    idot: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    toes: float = 0.0
    fit: float = 0.0
    f0: float = 0.0
    f1: float = 0.0
    f2: float = 0.0
    tgd: tuple = (0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass
class Geph:
    """GLONASS broadcast ephemeris (RTKLIB geph_t)."""
    sat: int = 0
    iode: int = 0
    frq: int = 0
    svh: int = 0
    sva: int = 0
    age: int = 0
    toe: GTime = dataclasses.field(default_factory=GTime)
    tof: GTime = dataclasses.field(default_factory=GTime)
    pos: list = dataclasses.field(default_factory=lambda: [0.0] * 3)
    vel: list = dataclasses.field(default_factory=lambda: [0.0] * 3)
    acc: list = dataclasses.field(default_factory=lambda: [0.0] * 3)
    taun: float = 0.0
    gamn: float = 0.0
    dtaun: float = 0.0


@dataclasses.dataclass
class SdrEph:
    """Per-channel decode context (reference sdreph_t, src/sdr.h:415-434)."""
    ctype: int = 0
    prn: int = 0
    eph: Eph = dataclasses.field(default_factory=Eph)
    geph: Geph = dataclasses.field(default_factory=Geph)
    tow_gpst: float = 0.0        # tow at the frame boundary (s)
    week_gpst: int = 0
    cnt: int = 0                 # decoded subframe/string counter
    cntth: int = 0               # subframes needed for a full ephemeris
    iode_sf2: int = -1           # IODE seen in subframe 2 (L1CA)
    iode_sf3: int = -2           # IODE seen in subframe 3 (distinct
                                 # defaults: incomplete never "matches")
    update: bool = False         # new ephemeris (IODE change) pending output
    # GLONASS merge scratch (src/sdrnav_glo.c:157-175)
    tk: list = dataclasses.field(default_factory=lambda: [0, 0, 0])
    nt: int = 0
    n4: int = 0
    s1cnt: int = 0
