"""Carrier-smoothed pseudoranges (Hatch filter).

Beyond-reference observable-quality stage: blend the noisy code
pseudorange with the mm-level carrier delta-range,

    Ps(k) = P(k)/n + (1 - 1/n) * (Ps(k-1) + lambda * (L(k) - L(k-1)))

with n ramping up to the window length N.  This framework's L convention
(obs/history.py): L accumulates D*dt cycles with dP/dt = +c*D/f_carrier,
so lambda*dL tracks dP directly (no sign flip).  The filter resets on a
tow gap or a code/carrier divergence beyond ``reset_m`` (cycle slip /
relock guard).  Single-frequency smoothing absorbs iono divergence over
long windows — keep N modest (reference-grade receivers use 10-100 s).
"""
from __future__ import annotations

from ..constants import CLIGHT, FREQ1, SYS_GLO, FREQ1_GLO, DFRQ1_GLO


class HatchSmoother:
    """Per-satellite Hatch filters over an epoch stream."""

    def __init__(self, window: int = 20, reset_m: float = 30.0):
        self.N = int(window)
        self.reset_m = float(reset_m)
        self._st = {}          # (sys, prn) -> [n, Ps, last_L, last_tow]

    def _lam(self, obs) -> float:
        if obs.sys == SYS_GLO:
            return CLIGHT / (FREQ1_GLO + obs.fcn * DFRQ1_GLO)
        return CLIGHT / FREQ1

    def smooth(self, obs_list, max_gap_s: float = 2.0):
        """Smooth one epoch's observables IN PLACE (obs.P updated);
        returns the list for chaining."""
        for o in obs_list:
            key = (o.sys, o.prn)
            st = self._st.get(key)
            lam = self._lam(o)
            if st is not None:
                n, Ps, last_L, last_tow = st
                pred = Ps + lam * (o.L - last_L)
                if (o.tow - last_tow) > max_gap_s or \
                        abs(o.P - pred) > self.reset_m:
                    st = None          # gap or cycle slip: restart
                else:
                    n = min(n + 1, self.N)
                    Ps = o.P / n + (1.0 - 1.0 / n) * pred
                    self._st[key] = [n, Ps, o.L, o.tow]
                    o.P = Ps
            if st is None:
                self._st[key] = [1, o.P, o.L, o.tow]
        return obs_list
