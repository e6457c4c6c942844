"""GNSS ranging-code generation.

Pure-NumPy generators for every code family the reference supports
(reference: src/sdrcode.c): GPS/QZSS L1C/A, L1C pilot/data (BOC(1,1)),
L1C overlay, GLONASS G1/G2, SBAS L1 (C/A), and Neuman-Hoffman secondaries.

Codes are returned as ±1 ``int8`` arrays with the reference's sign
convention (code bit 1 -> +1).  They are generated once at channel init and
uploaded to the device as correlation templates; generation itself is
host-side (sequential LFSRs, microseconds of work).

Unlike the reference, the GLONASS G1 code IS wired into the dispatch —
the reference's ``gencode`` switch misses ``CTYPE_G1`` (src/sdrcode.c:525-538)
so its GLONASS channels fail at init even though full G1 tracking/nav
paths exist; the capability is clearly intended and is restored here.
"""
from .registry import gencode, code_length, code_rate  # noqa: F401
from .l1ca import gencode_l1ca  # noqa: F401
from .l1c import gencode_l1cp, gencode_l1cd, gencode_l1co  # noqa: F401
from .glonass import gencode_g1g2  # noqa: F401
from .secondary import gencode_nh10, gencode_nh20  # noqa: F401
from .boc import boc  # noqa: F401
