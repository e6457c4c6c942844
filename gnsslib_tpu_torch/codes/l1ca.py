"""GPS/QZSS L1 C/A code generator (IS-GPS-200).

Bit-domain reimplementation of the G1/G2 Gold-code construction
(reference behavior: src/sdrcode.c:101-154).  Output chips are ±1 int8 with
code bit 1 -> +1 (the reference's ``-G1*G2`` convention).
"""
from __future__ import annotations

import numpy as np

LEN_L1CA = 1023
CRATE_L1CA = 1.023e6

# G2 delay in chips per PRN (IS-GPS-200 table 3-I; PRNs 1-210 incl. QZSS/SBAS)
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
    484, 289, 811, 202, 1021, 463, 568, 904, 670, 230,
    911, 684, 309, 644, 932, 12, 314, 891, 212, 185,
    675, 503, 150, 395, 345, 846, 798, 992, 357, 995,
    877, 112, 144, 476, 193, 109, 445, 291, 87, 399,
    292, 901, 339, 208, 711, 189, 263, 537, 663, 942,
    173, 900, 30, 500, 935, 556, 373, 85, 652, 310,
)

_MAXPRN = len(G2_DELAY)


def _lfsr_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Run the two 10-stage registers once; return G1 and G2 bit streams."""
    r1 = np.ones(10, dtype=np.uint8)
    r2 = np.ones(10, dtype=np.uint8)
    g1 = np.empty(LEN_L1CA, dtype=np.uint8)
    g2 = np.empty(LEN_L1CA, dtype=np.uint8)
    for i in range(LEN_L1CA):
        g1[i] = r1[9]
        g2[i] = r2[9]
        fb1 = r1[2] ^ r1[9]
        fb2 = r2[1] ^ r2[2] ^ r2[5] ^ r2[7] ^ r2[8] ^ r2[9]
        r1[1:] = r1[:-1]
        r2[1:] = r2[:-1]
        r1[0] = fb1
        r2[0] = fb2
    return g1, g2


_G1, _G2 = _lfsr_sequences()


def gencode_l1ca(prn: int) -> np.ndarray:
    """Return the 1023-chip ±1 C/A code for ``prn`` (1-210)."""
    if not 1 <= prn <= _MAXPRN:
        raise ValueError(f"L1CA prn out of range: {prn}")
    delay = G2_DELAY[prn - 1]
    g2 = np.roll(_G2, delay)           # delayed G2: g2[i] = G2[(i - delay) mod N]
    bits = _G1 ^ g2
    return (2 * bits.astype(np.int8) - 1)
