"""The benchmark's signal generator: GPS L1 C/A and SBAS L1 IF captures
made on the device from a seed.

A frozen copy of the receiver package's simulator math (``sim.synthesize``
and ``quantize_int8``, the C/A Gold codes, the LNAV subframe encoder with
its word parity, the SBAS message encoder with CRC-24Q and the rate-1/2
K=7 convolutional code), kept here so that later changes to the program
cannot move the yardstick.  The phases are float64, as in the simulator;
a capture is quantized to int8 and kept in host memory.  Nothing here
imports the receiver package.

A traffic mix (``rxbench/traffic/<name>.json``) names the satellites
present, the C/N0, the ranges of the satellites' distances, Dopplers and
Doppler rates, and the capture lengths; each capture draws every
satellite's distance (so its time of flight and code phase), Doppler,
Doppler rate and carrier phase uniformly from the run's seed
(:func:`draw_sky`), and its noise from a ``torch.Generator`` on the
device.  Each GPS satellite broadcasts an ephemeris of its own
(:func:`eph_of`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

F_CF = 1.57542e9                 # GPS/SBAS L1 carrier (Hz)
CRATE = 1.023e6                  # C/A chip rate (chips/s)
CLEN = 1023                      # C/A code length (chips)
TOW0 = 352800.0                  # GPS time of sample 0 (s of week)
WEEK = 2200
LNAV_PAD = 6.0                   # the first LNAV subframe starts 6 s in
LEAD = 1.0                       # nav streams start at TOW0 - LEAD (s)
CLIGHT = 299792458.0
SBAS_FIRST = 120                 # SBAS PRNs 120-158

# IS-GPS-200 table 3-I G2 delays (chips) for PRNs 1-158: GPS 1-32,
# then the rest of the table up to the SBAS PRNs
G2_DELAY = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950, 67, 103, 91,
    19, 679, 225, 625, 946, 638, 161, 1001, 554, 280,
    710, 709, 775, 864, 558, 220, 397, 55, 898, 759,
    367, 299, 1018, 729, 695, 780, 801, 788, 732, 34,
    320, 327, 389, 407, 525, 405, 221, 761, 260, 326,
    955, 653, 699, 422, 188, 438, 959, 539, 879, 677,
    586, 153, 792, 814, 446, 264, 1015, 278, 536, 819,
    156, 957, 159, 712, 885, 461, 248, 713, 126, 807,
    279, 122, 197, 693, 632, 771, 467, 647, 203, 145,
    175, 52, 21, 237, 235, 886, 657, 634, 762, 355,
    1012, 176, 603, 130, 359, 595, 68, 386, 797, 456,
    499, 883, 307, 127, 211, 121, 118, 163, 628, 853,
    484, 289, 811, 202, 1021, 463, 568, 904,
)


def _lfsr() -> tuple[np.ndarray, np.ndarray]:
    r1 = np.ones(10, np.uint8)
    r2 = np.ones(10, np.uint8)
    g1 = np.empty(CLEN, np.uint8)
    g2 = np.empty(CLEN, np.uint8)
    for i in range(CLEN):
        g1[i], g2[i] = r1[9], r2[9]
        fb1 = r1[2] ^ r1[9]
        fb2 = r2[1] ^ r2[2] ^ r2[5] ^ r2[7] ^ r2[8] ^ r2[9]
        r1[1:] = r1[:-1].copy()
        r2[1:] = r2[:-1].copy()
        r1[0], r2[0] = fb1, fb2
    return g1, g2


_G1, _G2 = _lfsr()


def ca_code(prn: int) -> np.ndarray:
    """The 1023-chip C/A code of ``prn`` (GPS 1-32, SBAS 120-158) as ±1
    int8, code bit 1 -> +1."""
    if not 1 <= prn <= len(G2_DELAY):
        raise ValueError(f"C/A PRN out of range: {prn}")
    bits = _G1 ^ np.roll(_G2, G2_DELAY[prn - 1])
    return (2 * bits.astype(np.int8) - 1).astype(np.int8)


# ----------------------------------------------------------------- LNAV
P2_5, P2_19, P2_29, P2_31 = 2.0 ** -5, 2.0 ** -19, 2.0 ** -29, 2.0 ** -31
P2_33, P2_43, P2_55 = 2.0 ** -33, 2.0 ** -43, 2.0 ** -55

# the simulator's example ephemeris, as the integers of its LNAV fields
# (IS-GPS-200 20.3.3.3-4); each satellite broadcasts a variant of it
EPH = dict(
    week10=(WEEK - 1024) & 0x3FF, code=1, sva=1, svh=0, iodc=77, flag=0,
    tgd=round(-1.0e-8 / P2_31), toc=int(TOW0 / 16.0), f2=0,
    f1=round(1.1e-11 / P2_43), f0=round(2.3e-4 / P2_31),
    iode=77, crs=round(-93.0 / P2_5), deln=round(1.4e-9 / P2_43),
    M0=round(0.12 / P2_31), cuc=round(-4.5e-6 / P2_29),
    e=round(0.012 / P2_33), cus=round(7.8e-6 / P2_29),
    sqrtA=int(5153.625 / P2_19), toes=int(TOW0 / 16.0), fit=0,
    cic=round(-1.1e-7 / P2_29), OMG0=round(-0.27 / P2_31),
    cis=round(9.0e-8 / P2_29), i0=round(0.31 / P2_31),
    crc=round(221.0 / P2_5), omg=round(0.45 / P2_31),
    OMGd=round(-2.5e-9 / P2_43), idot=round(2.0e-10 / P2_43))


def _semicircles(x: float) -> int:
    """An angle in semicircles, wrapped into [-1, 1), as its 32-bit
    field."""
    v = round((((x + 1.0) % 2.0) - 1.0) / P2_31)
    return max(min(v, (1 << 31) - 1), -(1 << 31))


def eph_of(prn: int) -> dict:
    """The ephemeris GPS ``prn`` broadcasts: the example's with its own
    issue of data, orbital plane, anomaly, eccentricity and radius, so
    that no two satellites' subframes 1-3 or RINEX records agree."""
    e = dict(EPH)
    e.update(iodc=64 + prn, iode=64 + prn,
             M0=_semicircles(0.12 + 0.0617 * prn),
             OMG0=_semicircles(-0.27 + (prn % 6) / 3.0),
             omg=_semicircles(0.45 + 0.013 * prn),
             i0=_semicircles(0.31 + 0.0005 * prn),
             e=round((0.012 + 0.0003 * prn) / P2_33),
             sqrtA=int((5153.625 + 0.01 * prn) / P2_19))
    return e


def eph_rinex(prn: int) -> dict:
    """:func:`eph_of` as RINEX writes it (physical units; angles in
    rad)."""
    e = eph_of(prn)
    return dict(
        M0=e["M0"] * P2_31 * math.pi, e=e["e"] * P2_33,
        sqrtA=e["sqrtA"] * P2_19, toes=e["toes"] * 16.0,
        OMG0=e["OMG0"] * P2_31 * math.pi, i0=e["i0"] * P2_31 * math.pi,
        omg=e["omg"] * P2_31 * math.pi, iode=float(e["iode"]),
        week=float(WEEK))


def _setbitu(buf: bytearray, pos: int, length: int, data: int) -> None:
    for i in range(length):
        bit = (data >> (length - 1 - i)) & 1
        p = pos + i
        if bit:
            buf[p // 8] |= 1 << (7 - p % 8)
        else:
            buf[p // 8] &= ~(1 << (7 - p % 8)) & 0xFF


def _setbits(buf: bytearray, pos: int, length: int, data: int) -> None:
    data = int(data)
    data = data | (1 << (length - 1)) if data < 0 else \
        data & ~(1 << (length - 1))
    _setbitu(buf, pos, length, data & ((1 << length) - 1))


_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)


def _word(d24, b29: int, b30: int):
    """24 source bits -> the transmitted 30-bit word (IS-GPS-200
    20.3.5.2): data XOR D30* of the previous word, then D25-D30."""
    x = (b29, b30, b29, b30, b30, b29)
    par = []
    for k, taps in enumerate(_PARITY_TAPS):
        p = x[k]
        for i in taps:
            p ^= int(d24[i - 1])
        par.append(p)
    return [b ^ b30 for b in d24] + par, par[4], par[5]


def _how_word(how22, b29: int, b30: int):
    """The HOW with bits 23-24 chosen so that D29 = D30 = 0."""
    for t23 in (0, 1):
        for t24 in (0, 1):
            w, n29, n30 = _word(list(how22) + [t23, t24], b29, b30)
            if n29 == 0 and n30 == 0:
                return w
    raise AssertionError("the HOW parity always has a solution")


def lnav_subframe(sfid: int, tow_next6: int, b29: int, b30: int,
                  seed: int = 7, eph: dict = EPH) -> np.ndarray:
    """Subframe ``sfid`` as 300 transmitted ±1 bits (+1 = binary 0):
    TLM, HOW (``tow_next6`` = TOW of the next subframe / 6 s), the
    ephemeris ``eph`` in subframes 1-3, seeded filler in 4-5."""
    rng = np.random.default_rng(seed * 10 + sfid)
    sf = bytearray(38)
    e = eph

    def u(pos, length, val):
        _setbitu(sf, pos, length, int(val))

    def s(pos, length, val):
        _setbits(sf, pos, length, int(val))

    def s2(p1, l1, p2, l2, val):
        v = int(val)
        if v < 0:
            v += 1 << (l1 + l2)
        u(p1, l1, (v >> l2) & ((1 << l1) - 1))
        u(p2, l2, v & ((1 << l2) - 1))

    u(0, 8, 0b10001011)
    u(8, 14, rng.integers(0, 1 << 14))
    u(30, 17, tow_next6)
    u(49, 3, sfid)
    if sfid == 1:
        u(60, 10, e["week10"])
        u(70, 2, e["code"])
        u(72, 4, e["sva"])
        u(76, 6, e["svh"])
        s2(82, 2, 210, 8, e["iodc"])
        u(90, 1, e["flag"])
        s(196, 8, e["tgd"])
        u(218, 16, e["toc"])
        s(240, 8, e["f2"])
        s(248, 16, e["f1"])
        s(270, 22, e["f0"])
    elif sfid == 2:
        u(60, 8, e["iode"])
        s(68, 16, e["crs"])
        s(90, 16, e["deln"])
        s2(106, 8, 120, 24, e["M0"])
        s(150, 16, e["cuc"])
        s2(166, 8, 180, 24, e["e"])
        s(210, 16, e["cus"])
        s2(226, 8, 240, 24, e["sqrtA"])
        u(270, 16, e["toes"])
        u(286, 1, e["fit"])
    elif sfid == 3:
        s(60, 16, e["cic"])
        s2(76, 8, 90, 24, e["OMG0"])
        s(120, 16, e["cis"])
        s2(136, 8, 150, 24, e["i0"])
        s(180, 16, e["crc"])
        s2(196, 8, 210, 24, e["omg"])
        s(240, 24, e["OMGd"])
        u(270, 8, e["iode"])
        s(278, 14, e["idot"])
    else:
        for w in range(2, 10):
            u(30 * w, 24, rng.integers(0, 1 << 24))
    src = np.unpackbits(np.frombuffer(bytes(sf), np.uint8))[:300]
    out = []
    for w in range(10):
        d24 = [int(b) for b in src[30 * w:30 * w + 24]]
        if w == 1:
            word = _how_word(d24[:22], b29, b30)
            b29, b30 = word[28], word[29]
        else:
            word, b29, b30 = _word(d24, b29, b30)
        out.extend(word)
    return (1 - 2 * np.asarray(out, np.int64)).astype(np.int64)


def lnav_stream(seconds: float, eph: dict = EPH, seed: int = 7,
                lead: float = 0.0) -> np.ndarray:
    """The LNAV bits (±1 int8, 50 bps) of a ``seconds``-long capture from
    TOW0 - ``lead``: a pad of alternating bits up to TOW0 + 6 s, then
    subframes 1, 2, ... of ``eph`` (subframe ``j`` starts at TOW0 + 6 +
    6 j), covering the capture."""
    npad = int(round((LNAV_PAD + lead) * 50.0))
    pad = np.concatenate([np.tile([1, -1], npad // 2 - 1), [1, 1]])
    bits, b29, b30 = [], 0, 0
    tow6 = int((TOW0 + LNAV_PAD) / 6.0)
    for j in range(int(math.ceil(max(seconds - LNAV_PAD, 0.0) / 6.0)) + 1):
        sf = lnav_subframe(j % 5 + 1, tow6 + j + 1, b29, b30, seed, eph)
        b29, b30 = int(sf[298] == -1), int(sf[299] == -1)
        bits.append(sf)
    return np.concatenate([pad] + bits).astype(np.int8)


def lnav_sfid(tow_start: float) -> int:
    """The subframe ID that starts at ``tow_start`` in :func:`lnav_stream`."""
    return int(round((tow_start - TOW0 - LNAV_PAD) / 6.0)) % 5 + 1


# ----------------------------------------------------------------- SBAS
def _crc24q_table() -> np.ndarray:
    tbl = np.zeros(256, np.uint32)
    for b in range(256):
        crc = b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= 0x1864CFB
        tbl[b] = crc & 0xFFFFFF
    return tbl


_CRC24 = _crc24q_table()


def crc24q(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFF) ^ int(_CRC24[(crc >> 16) ^ b])
    return crc


def sbas_message(mt: int, payload212: np.ndarray, preamble: int
                 ) -> np.ndarray:
    """One 250-bit SBAS message as 0/1 bits: 8-bit preamble, 6-bit type,
    212-bit payload, CRC-24Q over the 226 bits before it (DO-229)."""
    b = np.zeros(250, np.int64)
    b[0:8] = [(preamble >> (7 - i)) & 1 for i in range(8)]
    b[8:14] = [(mt >> (5 - i)) & 1 for i in range(6)]
    b[14:226] = np.asarray(payload212, np.int64)[:212]
    body = np.packbits(np.concatenate([np.zeros(6, np.int64), b[:226]])
                       .astype(np.uint8))
    crc = crc24q(bytes(body))
    b[226:250] = [(crc >> (23 - i)) & 1 for i in range(24)]
    return b


def sbas_messages(seconds: float, rng: np.random.Generator,
                  first: int = 0) -> list:
    """One message per second (0/1 bits each) for k = ``first``, ...:
    MT12 with GPS time every third, MT63 with ``rng``'s payload between,
    preambles 53/9A/C6 in turn.  Message ``k`` is transmitted over
    [TOW0 + k, TOW0 + k + 1)."""
    msgs = []
    for k in range(first, int(seconds) + 2):
        pre = (0x53, 0x9A, 0xC6)[k % 3]
        if k % 3 == 0:
            payload = np.zeros(212, np.int64)
            tow = int(TOW0) + k + 2
            for i in range(20):
                payload[93 + i] = (tow >> (19 - i)) & 1
            wk = (WEEK - 1024) & 0x3FF
            for i in range(10):
                payload[113 + i] = (wk >> (9 - i)) & 1
            msgs.append(sbas_message(12, payload, pre))
        else:
            msgs.append(sbas_message(63, rng.integers(0, 2, 212), pre))
    return msgs


def _parity7(x: int) -> int:
    return bin(x).count("1") & 1


def conv27(bits01: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 convolutional code (polynomials 0x4F, 0x6D, the first
    symbol first) of 0/1 bits -> 0/1 symbols."""
    out = np.empty(2 * len(bits01), np.int64)
    r = 0
    for i, b in enumerate(bits01):
        r = ((r << 1) | int(b)) & 0x7F
        out[2 * i] = _parity7(r & 0x4F)
        out[2 * i + 1] = _parity7(r & 0x6D)
    return out


def sbas_symbols(msgs: list) -> np.ndarray:
    """500 sps ±1 int8 symbols of ``msgs`` (binary 1 -> -1 on both
    sides of the encoder)."""
    sym = conv27(np.concatenate(msgs))
    return np.where(sym == 0, 1, -1).astype(np.int8)


# ----------------------------------------------------------------- sky
@dataclasses.dataclass
class Signal:
    """One satellite of a capture (the simulator's conventions: the
    receiver reports Doppler ``doppler + rate * t`` at stream time t and
    acquires the carrier at f_if minus that).  ``code_phase`` counts the
    chips sent from TOW0 - LEAD (where ``nav_bits`` start) until the
    signal that reaches sample 0 left: CRATE * (LEAD - ``delay``)."""
    prn: int
    kind: str                   # "gps" or "sbas"
    doppler: float              # Hz at sample 0
    rate: float                 # Doppler rate, Hz/s
    delay: float                # time of flight at sample 0 (s)
    carr_phase: float           # cycles at sample 0
    nav_bits: np.ndarray        # ±1 int8 at nav_ms, from TOW0 - LEAD
    nav_ms: float
    amplitude: float = 1.0
    messages: list | None = None   # SBAS: the 0/1 bits of each message,
    #                                the first sent from TOW0 - LEAD

    @property
    def code_phase(self) -> float:
        return CRATE * (LEAD - self.delay)


@dataclasses.dataclass
class Sky:
    signals: list
    seconds: float
    cn0_dbhz: float

    def present(self, kind: str) -> list:
        return [s.prn for s in self.signals if s.kind == kind]

    def by_prn(self, kind: str, prn: int) -> Signal | None:
        return next((s for s in self.signals
                     if s.kind == kind and s.prn == prn), None)


def draw_sky(traffic: dict, rng: np.random.Generator, seconds: float
             ) -> Sky:
    """The satellites of one capture: every PRN the traffic names, each
    at a distance drawn uniformly in ``<kind>_range_km`` (its time of
    flight), with a Doppler drawn uniformly in ±``<kind>_doppler_hz``, a
    Doppler rate in ±``<kind>_rate_hz_s`` and a carrier phase in [0, 1);
    GPS signals carry the LNAV stream of their own ephemeris, SBAS ones
    their own message stream (MT63 payloads from ``rng``)."""
    sigs = []
    for kind in ("gps", "sbas"):
        lo, hi = traffic[f"{kind}_range_km"]
        span = float(traffic[f"{kind}_doppler_hz"])
        rspan = float(traffic[f"{kind}_rate_hz_s"])
        for prn in traffic.get(kind, []):
            delay = float(rng.uniform(lo, hi)) * 1e3 / CLIGHT
            d = float(rng.uniform(-span, span))
            r = float(rng.uniform(-rspan, rspan))
            cph = float(rng.uniform(0.0, 1.0))
            if kind == "gps":
                sigs.append(Signal(prn, kind, d, r, delay, cph, lnav_stream(
                    seconds, eph_of(prn), prn, LEAD), 20.0))
            else:
                msgs = sbas_messages(seconds, rng, -int(LEAD))
                sigs.append(Signal(prn, kind, d, r, delay, cph,
                                   sbas_symbols(msgs), 2.0, messages=msgs))
    return Sky(sigs, float(seconds), float(traffic["cn0_dbhz"]))


def noise_std(cn0_dbhz: float, f_sf: float) -> float:
    """Per-sample noise sigma of real sampling for a unit-amplitude
    signal at ``cn0_dbhz``: C/N0 = f_sf / (2 sigma^2)."""
    return math.sqrt(f_sf / (2.0 * 10.0 ** (cn0_dbhz / 10.0)))


def int8_scale(sky: Sky, f_sf: float) -> float:
    """The int8 scale: noise and the composite of the signals at a third
    of the range, clear of clipping."""
    sig = noise_std(sky.cn0_dbhz, f_sf)
    return 110.0 / (3.0 * math.sqrt(sig ** 2 + len(sky.signals) / 2.0))


def synthesize(sky: Sky, f_sf: float, f_if: float, nsamples: int, *,
               device, noise_seed: int | None, scale: float | None = None,
               chunk: int = 1 << 24):
    """The capture as a host int8 ``torch`` tensor of ``nsamples`` real
    samples: the sum of ``sky``'s signals (float64 phases), Gaussian
    noise at the sky's C/N0 from a ``torch.Generator`` on ``device``
    seeded with ``noise_seed`` (None: no noise), ``clip(round(x *
    scale))``.  Made in chunks of ``chunk`` samples on ``device``."""
    import torch
    dev = torch.device(device)
    f64 = torch.float64
    scale = int8_scale(sky, f_sf) if scale is None else scale
    sig = noise_std(sky.cn0_dbhz, f_sf)
    gen = None
    if noise_seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(noise_seed) % (1 << 63))
    tabs = []
    for s in sky.signals:
        tabs.append((torch.from_numpy(ca_code(s.prn).astype(np.float64))
                     .to(dev),
                     torch.from_numpy(s.nav_bits.astype(np.float64)).to(dev)))
    out = torch.empty(nsamples, dtype=torch.int8)
    for s0 in range(0, nsamples, chunk):
        n = min(chunk, nsamples - s0)
        t = (s0 + torch.arange(n, dtype=f64, device=dev)) / f_sf
        x = torch.zeros(n, dtype=f64, device=dev)
        for s, (code, bits) in zip(sky.signals, tabs):
            dphi = s.doppler * t + 0.5 * s.rate * t * t
            chips = s.code_phase + CRATE * (t - dphi / F_CF)
            c = code[torch.remainder(torch.floor(chips).long(), CLEN)]
            bpc = CRATE * s.nav_ms * 1e-3
            c = c * bits[torch.remainder(torch.floor(chips / bpc).long(),
                                         bits.shape[0])]
            phase = 2.0 * math.pi * (f_if * t - dphi + s.carr_phase)
            x += s.amplitude * c * torch.cos(phase)
            del dphi, chips, c, phase
        if gen is not None:
            x += sig * torch.randn(n, generator=gen, device=dev, dtype=f64)
        q = torch.clamp(torch.round(x * scale), -128, 127).to(torch.int8)
        out[s0:s0 + n].copy_(q)
        del t, x, q
    return out
