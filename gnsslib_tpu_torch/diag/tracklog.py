"""Per-channel CSV tracking logs, reference column layout.

Reference: createlog/writelog_header/writelog (src/sdrout.c:386-457),
files named log<SAT>.csv.  One row per loop-filter update (the reference
writes per period; update-cadence rows carry the meaningful loop state).
"""
from __future__ import annotations

import os

import numpy as np


class TrackLogger:
    def __init__(self, path: str, satstr: str, corrn: int, corrd: int,
                 crate: float, f_if: float):
        os.makedirs(path, exist_ok=True)
        self.fp = open(os.path.join(path, f"log{satstr}.csv"), "w")
        self.corrn = corrn
        self.crate = crate
        self.f_if = f_if
        # tap display order: most-early .. prompt .. most-late
        # (reference index juggling, sdrout.c:390-398)
        self.ind = ([2 * (corrn - i) - 1 for i in range(corrn)] + [0]
                    + [2 * (i + 1) for i in range(corrn)])
        corrx = ([-corrd * (corrn - i) for i in range(corrn)] + [0]
                 + [corrd * (i + 1) for i in range(corrn)])
        cols = "Cnt,Tow,IP,QP,sumI,sumQ"
        cols += "".join(f",I({x})" for x in corrx)
        cols += (",Code Freq,Code Err,Code NCO,Carr Freq,Carr Err,"
                 "Carr NCO,Freq Err,Carrier Phase,FlagSync,FlagSyncf,"
                 "FlagTOW,FlagDec,FlagLoopFilter,swsync")
        self.fp.write(cols + "\n")

    def log_block(self, out, ch_idx: int, nav, hist, cnt0: int) -> None:
        """Append rows for the loop-update periods of one block."""
        upd = np.nonzero(out.flagloopfilter[:, ch_idx] > 0)[0]
        for k in upd:
            k = int(k)
            si = out.sum_i[k, ch_idx]
            sq = out.sum_q[k, ch_idx]
            tow = (nav.firstsftow + (cnt0 + k - nav.firstsfcnt) * 1e-3
                   if nav.flagtow else 0.0)
            taps = ",".join(f"{si[j]:.3f}" for j in self.ind)
            self.fp.write(
                f"{cnt0 + k},{tow:.3f},{out.ip[k, ch_idx]:.3f},"
                f"{out.qp[k, ch_idx]:.3f},{si[0]:.3f},{sq[0]:.3f},{taps},"
                f"{self.crate + out.dcode[k, ch_idx]:.3f},"
                f"{out.code_err[k, ch_idx]:.6f},"
                f"{out.code_nco[k, ch_idx]:.6f},"
                f"{self.f_if + out.dcarr[k, ch_idx]:.3f},"
                f"{out.carr_err[k, ch_idx]:.6f},"
                f"{out.carr_nco[k, ch_idx]:.6f},"
                f"0,{hist.L[0] if hist is not None else 0.0:.3f},"
                f"{int(nav.flagsync)},{int(nav.flagsyncf)},"
                f"{int(nav.flagtow)},{int(nav.flagdec)},"
                f"{out.flagloopfilter[k, ch_idx]},0\n")

    def close(self):
        self.fp.close()
