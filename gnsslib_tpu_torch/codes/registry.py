"""Code-generation dispatch (the reference's ``gencode``).

Reference behavior: src/sdrcode.c:515-539, with the GLONASS G1 case wired
(the reference's switch omits CTYPE_G1, making its GLONASS channels fail at
init; the capability is intended and restored here).
"""
from __future__ import annotations

import numpy as np

from ..constants import CodeType
from . import boc as _boc
from . import glonass, l1c, l1ca, secondary


def gencode(prn: int, ctype: int) -> tuple[np.ndarray, float]:
    """Return (±1 int8 code array, chip rate in chips/s) for a code type."""
    ctype = CodeType(ctype)
    if ctype == CodeType.L1CA or ctype == CodeType.L1SBAS:
        return l1ca.gencode_l1ca(prn), l1ca.CRATE_L1CA
    if ctype == CodeType.L1CP:
        # BOC(1,1) stand-in for TMBOC(6,1,1/11), as in the reference
        code, mult = _boc.boc(l1c.gencode_l1cp(prn), 1, 1)
        return code, l1c.CRATE_L1C * mult
    if ctype == CodeType.L1CD:
        code, mult = _boc.boc(l1c.gencode_l1cd(prn), 1, 1)
        return code, l1c.CRATE_L1C * mult
    if ctype == CodeType.L1CO:
        return l1c.gencode_l1co(prn), l1c.CRATE_L1CO
    if ctype == CodeType.G1:
        return glonass.gencode_g1g2(), glonass.CRATE_G1G2
    if ctype == CodeType.NH10:
        return secondary.gencode_nh10(), secondary.CRATE_NH10
    if ctype == CodeType.NH20:
        return secondary.gencode_nh20(), secondary.CRATE_NH20
    raise ValueError(f"unsupported code type: {ctype}")


def code_length(ctype: int) -> int:
    return len(gencode(1, ctype)[0])


def code_rate(ctype: int) -> float:
    return gencode(1, ctype)[1]
