"""Steady-state fast tracking: L code periods per super-step (port of
:mod:`gnsslib_tpu.track.fast`).

After nav bit sync every channel's loop filter runs once per ``loop``
periods, so between updates all NCO rates are constant and the L-period
span is closed form:

* window placement, code phase and carrier phase for all L periods are
  (C, L) vector math (``_geo_only``);
* all C*L windows correlate in one call of the correlator backend that
  ``corr`` names (one kernel launch per super-step on a card):

  - ``"band"`` (default): windows read straight from the block,
    :func:`~gnsslib_tpu_torch.ops.band_taps.band_taps` (kernel K1);
  - ``"pallas"``: windows fetched first (``_fetch_windows``, bf16), direct
    phase, :func:`~gnsslib_tpu_torch.ops.window_taps.correlate_windows16`
    (K3);
  - ``"fused"``: window rows fetched and masked first, factored carrier,
    :func:`~gnsslib_tpu_torch.ops.gram_taps.gram_taps` (K2);
  - ``"xla"``: fetched windows through the plain eager formulation of the
    JAX package's einsum backend (``_taps_xla``), no kernel;

* exactly one loop-filter update per channel per super-step
  (``_filter``), with the same discriminators and NCO equations as the
  per-period path.

The super-step scan of the JAX package is a Python loop here
(:meth:`FastTracker.run_steps`); on a card a block's loop is captured once
per backend in a CUDA graph and replayed per block (:mod:`.program`, the
counterpart of the jitted ``FastTracker._run``).  Per-period outputs come
back in the per-period layout, so the Receiver treats this as a drop-in
Tracker for the steady state.  Requirements: all channels bit-synced and
sharing one ``loop`` interval.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops.band_taps import band_taps
from ..ops.carrier import TWO_PI
from ..ops.gram_taps import gram_taps
from ..ops.nco import frac
from ..ops.window_taps import correlate_windows16
from .loop import F32, I32, Tracker, TrackOutputs, discriminators
from .program import BlockRunner
from .state import loop_interval

BACKENDS = ("band", "pallas", "fused", "xla")
UNPORTED_BACKENDS = ("diag", "diag2")


class FastTracker(BlockRunner):
    """Wraps a :class:`Tracker` for the post-bit-sync steady state.

    ``use_pallas`` keeps the JAX package's meaning: ``None`` selects the
    default backend ``"band"``, ``True`` selects ``"pallas"``, ``False``
    selects ``"xla"``.  Assign :attr:`corr` to choose any backend."""

    stage = "steady"

    def __init__(self, tracker: Tracker, use_pallas: bool | None = None):
        loops = {int(loop_interval(ct)) for ct in tracker._ctypes}
        if len(loops) != 1:
            raise ValueError("fast path needs a uniform loop interval; "
                             f"got {loops}")
        self.trk = tracker
        self.device = tracker.device
        self.L = loops.pop()
        self.C = tracker.C
        self.n_nom = tracker.n_nom
        self.nwin = tracker.nwin
        self.next = tracker.next
        self.smax = tracker.smax
        self.offsets = tracker.offsets
        self.cfg = tracker.cfg
        self.ti = tracker.ti

        L, nbar = self.L, self.n_nom
        ci0 = tracker.crate * tracker.ti
        f_base = tracker._f_base
        self.emax = int(np.ceil(L / 2 + self.smax + 2.0 / ci0.min() + 16))
        e = np.arange(-self.emax, self.emax + 1, dtype=np.float64)
        k = np.arange(L + 1, dtype=np.float64)
        fconsts = dict(
            base_adv_k=np.mod(f_base[:, None] * tracker.ti * nbar
                              * k[None, :], 1.0).astype(np.float32),
            base_adv_e=np.mod(f_base[:, None] * tracker.ti * e[None, :],
                              1.0).astype(np.float32),
            clen_k=(np.asarray(tracker._clens, np.float64)[:, None]
                    * k[None, :]).astype(np.float32),
            fbt=np.mod(f_base * tracker.ti, 1.0).astype(np.float32),
        )
        self._fconsts = {kk: torch.from_numpy(v).to(self.device)
                         for kk, v in fconsts.items()}
        # window rows of the fetch backends: nwin rounded up to whole
        # 128-sample rows
        self._fetch_k = (self.nwin + 127) // 128
        self.corr = ("band" if use_pallas is None
                     else "pallas" if use_pallas else "xla")
        self._bind()

    def _bind(self) -> None:
        """Take the tracker's constants and loop bridges, build the index
        tensors on ``device`` and start an empty program cache."""
        tracker, dev = self.trk, self.device
        self._consts = tracker._consts
        self._ki = torch.arange(self.L, dtype=F32, device=dev)
        self._fetch_i = torch.arange(self._fetch_k * 128, device=dev)
        self.state_to_carry = tracker.state_to_carry
        self.carry_to_state = tracker.carry_to_state
        self.programs = {}   # block programs by (corr, nsuper, block shape)

    def shard(self, sl: slice, tracker: Tracker) -> "FastTracker":
        """This fast path over channels ``sl``, on ``tracker`` (the
        :meth:`Tracker.shard` of the same slice): the channel slice of
        every per-channel constant, the same span tables and ``corr``, and
        block programs of its own (a shard of
        :class:`~..parallel.sharded.ShardedFastTracker`)."""
        f = copy.copy(self)
        f.trk, f.device, f.C = tracker, tracker.device, tracker.C
        f._fconsts = {k: v[sl].to(f.device)
                      for k, v in self._fconsts.items()}
        f._bind()
        return f

    @property
    def corr(self) -> str:
        """The correlator backend: ``"band"``, ``"pallas"``, ``"fused"`` or
        ``"xla"``.  ``"diag"``/``"diag2"`` (the JAX package's XLA Gram
        formulations) are not ported and raise ``NotImplementedError``.
        The JAX package's ``2*smax <= 64`` rule for ``"fused"`` belonged
        to its split 64-lane Gram layout; the port's K2 has no such layout
        and takes any tap geometry."""
        return self._corr

    @corr.setter
    def corr(self, value: str) -> None:
        if value in UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"corr={value!r} is not ported; use one of {BACKENDS}")
        if value not in BACKENDS:
            raise ValueError(f"corr={value!r}: expected one of {BACKENDS}")
        self._corr = value

    def _base_e(self, e: torch.Tensor) -> torch.Tensor:
        """base_adv_e[c, e + emax] for (C, ...) sample offsets ``e``; an
        offset outside the table gives 0, as the JAX one-hot does."""
        j = e.long() + self.emax
        valid = (j >= 0) & (j <= 2 * self.emax)
        tab = self._fconsts["base_adv_e"]
        flat = j.clamp(0, 2 * self.emax).reshape(self.C, -1)
        v = tab.gather(1, flat).reshape(e.shape)
        return torch.where(valid, v, 0.0)

    def _geo_only(self, st: dict) -> dict:
        """Closed-form geometry of one super-step, (C, L) per quantity:
        period boundaries, replica rows, window starts, carrier phases."""
        L, nbar = self.L, self.n_nom
        cc, fc = self._consts, self._fconsts
        ci0 = cc["ci0"][:, None]
        ci = ci0 + st["dci"][:, None]
        ki = self._ki[None, :]
        remcode = st["remcode"][:, None]

        d = torch.round((fc["clen_k"] - remcode) / ci)       # (C, L+1)
        n_k = (d[:, 1:] - d[:, :-1]).to(I32)
        remcode_k = remcode + ci * d[:, :L] - fc["clen_k"][:, :L]

        phi = remcode_k - ci0 * self.smax
        s = phi / ci0
        m = torch.floor(s)
        Q = self.trk._tbl_q
        q_idx = torch.floor((s - m) * Q).to(I32)
        m = m.to(I32) + torch.div(q_idx, Q, rounding_mode="floor")
        q_idx = torch.remainder(q_idx, Q)

        # the window start absorbs the replica's integer shift
        dprime = d[:, :L].to(I32) - m
        e_k = dprime - (ki * nbar).to(I32)
        wstart = st["loc"][:, None] + dprime

        base_e = self._base_e(e_k)
        w = frac(st["dcps"] * nbar)[:, None]
        rem_k = frac(st["remcarr"][:, None] + fc["base_adv_k"][:, :L]
                     + base_e + frac(w * ki)
                     + st["dcps"][:, None] * e_k.to(F32))
        return dict(d=d, n_k=n_k, remcode_k=remcode_k, rem_k=rem_k,
                    wstart=wstart, q_idx=q_idx)

    def _replica_rows(self, q_idx: torch.Tensor) -> torch.Tensor:
        """(C, L) quantized-phase indices -> (C*L, next) int8 rows."""
        C, L = q_idx.shape
        Q = self.trk._tbl_q
        table = self._consts["table"]
        row_idx = (torch.arange(C, device=q_idx.device)[:, None] * Q
                   + q_idx.long()).reshape(C * L)
        rows = table.reshape(C * Q, table.shape[-1]).index_select(0, row_idx)
        m0 = self.trk._tbl_m0
        return rows[:, m0:m0 + self.next].contiguous()

    def _filter(self, st: dict, geo: dict, cur_i: torch.Tensor,
                cur_q: torch.Tensor):
        """One loop-filter update per channel + end-of-step carries."""
        cfg = self.cfg
        L, nbar = self.L, self.n_nom
        cc, fc = self._consts, self._fconsts
        ci = cc["ci0"] + st["dci"]
        d, n_k = geo["d"], geo["n_k"]
        remcode_k, rem_k = geo["remcode_k"], geo["rem_k"]
        w = frac(st["dcps"] * nbar)

        k_c = torch.remainder(st["sync_offset"] - 1 - st["cnt"], cc["loop"])
        kc = k_c.long()
        kc3 = kc[:, None, None].expand(-1, 1, cur_i.shape[2])

        def at_kc(x):                                   # (C, L, T) -> (C, T)
            return x.gather(1, kc3)[:, 0]
        csum_i = st["sum_i"][:, None, :] + torch.cumsum(cur_i, dim=1)
        csum_q = st["sum_q"][:, None, :] + torch.cumsum(cur_q, dim=1)
        sum_i_u = at_kc(csum_i)
        sum_q_u = at_kc(csum_q)
        prevtaps_i = torch.cat([st["prev_i"][:, None, :], cur_i[:, :-1]], 1)
        prevtaps_q = torch.cat([st["prev_q"][:, None, :], cur_q[:, :-1]], 1)
        oldsum_i_u = st["oldsum_i"] + at_kc(torch.cumsum(prevtaps_i, dim=1))
        oldsum_q_u = st["oldsum_q"] + at_kc(torch.cumsum(prevtaps_q, dim=1))

        q2 = cfg.prm2
        dt = cc["dt2"]
        carr_err, freq_err, code_err = discriminators(
            sum_i_u, sum_q_u, oldsum_i_u, oldsum_q_u, cfg.ne, cfg.nl)
        carr_nco = (st["carr_nco"] + q2.pllaw * (carr_err - st["carr_err"])
                    + q2.pllw2 * dt * carr_err + q2.fllw * dt * freq_err)
        code_nco = (st["code_nco"] + q2.dllaw * (code_err - st["code_err"])
                    + q2.dllw2 * dt * code_err)
        dcarr_hz = st["dcarr_acq"] + carr_nco
        dcode_hz = -code_nco + dcarr_hz * cc["aid"]

        after = (self._ki[None, :] > k_c.to(F32)[:, None])[..., None]
        sum_i_end = torch.where(after, cur_i, 0.0).sum(1)
        sum_q_end = torch.where(after, cur_q, 0.0).sum(1)
        oldsum_i_end = torch.where(after, prevtaps_i, 0.0).sum(1)
        oldsum_q_end = torch.where(after, prevtaps_q, 0.0).sum(1)

        dL = d[:, L]
        remcode_out = st["remcode"] + ci * dL - fc["clen_k"][:, L]
        eL_end = dL.to(I32) - L * nbar
        remcarr_out = frac(st["remcarr"] + fc["base_adv_k"][:, L]
                           + self._base_e(eL_end) + frac(w * float(L))
                           + st["dcps"] * eL_end.to(F32))

        new = dict(
            loc=st["loc"] + dL.to(I32),
            cnt=st["cnt"] + L,
            remcode=remcode_out, remcarr=remcarr_out,
            dcps=dcarr_hz * self.ti,
            dci=(-code_nco + dcarr_hz * cc["aid"]) * self.ti,
            carr_nco=carr_nco, code_nco=code_nco,
            carr_err=carr_err, code_err=code_err, freq_err=freq_err,
            sum_i=sum_i_end, sum_q=sum_q_end,
            oldsum_i=oldsum_i_end, oldsum_q=oldsum_q_end,
            prev_i=cur_i[:, L - 1], prev_q=cur_q[:, L - 1],
        )
        kc1 = kc[:, None]
        packf = torch.cat([
            cur_i[..., 0], cur_q[..., 0],
            remcode_k.gather(1, kc1), rem_k.gather(1, kc1),
            sum_i_u, sum_q_u,
            torch.stack([dcarr_hz, dcode_hz, carr_err, code_err, carr_nco,
                         code_nco], 1)], dim=1)
        packi = torch.cat([
            st["loc"][:, None] + d[:, :L].to(I32), k_c[:, None].to(I32),
            n_k.gather(1, kc1)], dim=1)
        return new, packf, packi

    # ------------------------------------------------------------------ #
    def _block_rows(self, block: torch.Tensor) -> torch.Tensor:
        """The block cut to whole 128-sample rows, (nrow, 128) real or
        (nrow, 128, 2) I/Q (a view) — the extent ``_fetch_windows`` and
        the JAX package's row take see."""
        nrow = block.shape[0] // 128
        return block[:nrow * 128].reshape((nrow, 128) + block.shape[1:])

    def _fetch_windows(self, block2: torch.Tensor, wstart: torch.Tensor,
                       rowform: bool = False, nvalid=None):
        """(B,) window starts -> (B, nwin[, 2]) bf16 windows, or with
        ``rowform`` (B, K, 128) bf16 rows (a tuple (I, Q) of them for I/Q
        blocks), zeroed from ``nvalid`` on when it is given.

        Plain indexing of the block rows ``block2``: sample wstart + i of
        the rows' extent.  Indices are clamped into the block, so a window
        that leaves it (an inactive channel's far-negative start after
        ``rebase``) reads edge samples instead of faulting the device; the
        active mask discards such windows, and the out-of-block flag of
        :meth:`_inside` catches active ones.  bf16 is exact for the 8-bit
        sample alphabet of every capture path."""
        B = wstart.shape[0]
        flat = block2.reshape((-1,) + block2.shape[2:])
        nout = self._fetch_k * 128 if rowform else self.nwin
        i = self._fetch_i[:nout]
        idx = (wstart.long()[:, None] + i[None, :]).clamp_(0, flat.shape[0]
                                                            - 1)
        win = flat[idx].to(torch.bfloat16)                # (B, nout[, 2])
        if nvalid is not None:
            keep = i[None, :] < nvalid.long()[:, None]
            if win.dim() == 3:
                keep = keep[..., None]
            win = torch.where(keep, win, torch.zeros((), dtype=win.dtype,
                                                     device=win.device))
        if not rowform:
            return win
        win = win.reshape((B, self._fetch_k, 128) + win.shape[2:])
        if win.dim() == 4:
            return win[..., 0].contiguous(), win[..., 1].contiguous()
        return win

    @staticmethod
    def _inside(block2, wstart, n, active) -> torch.Tensor:
        """False when an ACTIVE window's samples [wstart, wstart + n) leave
        the block rows (0-dim bool tensor)."""
        extent = block2.shape[0] * 128
        w0 = wstart.long()
        inside = (w0 >= 0) & (w0 + n.long().clamp(min=0) <= extent)
        return torch.all(~active | inside)

    def _taps_xla(self, st: dict, geo: dict, win: torch.Tensor,
                  rc: torch.Tensor):
        """The JAX package's einsum backend (``_taps_xla``) in plain
        PyTorch: carrier from the channel's base-phase table, mixed
        samples rounded to bf16, f32 tap sums.  Returns (cur_i, cur_q),
        each (C, L, T)."""
        C, L, nwin, smax = self.C, self.L, self.nwin, self.smax
        i = self.trk._iwin_f
        ph = frac(self._consts["base_phase"][:, None, :]
                  + frac(st["dcps"][:, None] * i[None, :])[:, None, :]
                  + geo["rem_k"][:, :, None])                # (C, L, nwin)
        ang = TWO_PI * ph
        c, s = torch.cos(ang), torch.sin(ang)
        w = win.to(F32).reshape((C, L) + win.shape[1:])
        if w.dim() == 4:
            wr, wi = w[..., 0], w[..., 1]
            mr, mi = wr * c - wi * s, wr * s + wi * c
        else:
            mr, mi = w * c, w * s
        keep = i[None, None, :] < geo["n_k"].to(F32)[..., None]
        mr = torch.where(keep, mr, 0.0).to(torch.bfloat16).to(F32)
        mi = torch.where(keep, mi, 0.0).to(torch.bfloat16).to(F32)
        rcf = rc.to(F32).reshape(C, L, -1)
        zr, zi = [], []
        for o in self.offsets:
            rep = rcf[..., smax + int(o):smax + int(o) + nwin]
            zr.append((rep * mr).sum(-1))
            zi.append((rep * mi).sum(-1))
        scale = self.trk._tbl_scale
        # reference I/Q mapping (see loop.py): cur_q = real, cur_i = imag
        return (torch.stack(zi, -1) * scale, torch.stack(zr, -1) * scale)

    def _correlate(self, block, block2, st: dict, geo: dict,
                   rc: torch.Tensor):
        """All taps of one super-step through the ``corr`` backend ->
        (cur_i, cur_q) each (C, L, T), and the 0-dim bool ok flag (False
        when an active window left the block)."""
        C, L = self.C, self.L
        B = C * L

        def flat(t):
            return t.reshape(B).contiguous()
        wstart, n, rem = flat(geo["wstart"]), flat(geo["n_k"]), \
            flat(geo["rem_k"])
        ftot = flat((self._fconsts["fbt"] + st["dcps"])[:, None].expand(C, L))
        act = flat(st["active"][:, None].expand(C, L))
        if self._corr == "band":
            z2, ok = band_taps(block, rc, wstart, n, rem, ftot, act,
                               self.offsets, self.smax)
        else:
            ok = self._inside(block2, wstart, n, act)
            if self._corr == "xla":
                cur_i, cur_q = self._taps_xla(
                    st, geo, self._fetch_windows(block2, wstart), rc)
                return cur_i, cur_q, ok
            if self._corr == "pallas":
                z2 = correlate_windows16(self._fetch_windows(block2, wstart),
                                         rc, rem, ftot, n, self.offsets,
                                         self.smax)
            else:                                       # "fused"
                rows = self._fetch_windows(block2, wstart, rowform=True,
                                           nvalid=n)
                wi, wq = rows if isinstance(rows, tuple) else (rows, None)
                z2 = gram_taps(wi, wq, rc, rem, ftot, self.offsets,
                               self.smax)
        if self.trk._tbl_scale != 1.0:
            z2 = z2 * self.trk._tbl_scale
        z2 = z2.reshape(C, L, -1)
        return z2[..., 1::2], z2[..., 0::2], ok

    @staticmethod
    def _merge(carry: dict, new: dict) -> dict:
        """Active channels take the filter's new values; inactive ones
        keep theirs."""
        a = carry["active"]
        return {k: (torch.where(a.view((-1,) + (1,) * (v.dim() - 1)),
                                new[k], v) if k in new else v)
                for k, v in carry.items()}

    def run_steps(self, carry: dict, block: torch.Tensor, nsuper: int):
        """``nsuper`` super-steps -> (carry, packf (S, C, F),
        packi (S, C, L+3)).  The last int column is the correlator's ok
        flag of that step (False: an active window left the block)."""
        C = self.C
        block2 = self._block_rows(block) if self._corr != "band" else None
        pf, pi = [], []
        for _ in range(int(nsuper)):
            geo = self._geo_only(carry)
            rc = self._replica_rows(geo["q_idx"])
            cur_i, cur_q, ok = self._correlate(block, block2, carry, geo, rc)
            new, packf, packi = self._filter(carry, geo, cur_i, cur_q)
            carry = self._merge(carry, new)
            pf.append(packf)
            pi.append(torch.cat(
                [packi, ok.to(I32).expand(C)[:, None]], dim=1))
        return carry, torch.stack(pf), torch.stack(pi)

    def _pack_fields(self) -> tuple:
        """The (name, width) of each float telemetry column, in order."""
        L, taps = self.L, self.cfg.ntaps
        return tuple(zip(
            ("ip", "qp", "remcode_u", "remcarr_u", "sum_i_u", "sum_q_u",
             "dcarr", "dcode", "carr_err", "code_err", "carr_nco",
             "code_nco"),
            (L, L, 1, 1, taps, taps, 1, 1, 1, 1, 1, 1)))

    def pack_widths(self) -> tuple[int, int]:
        """The float and int columns of a channel's telemetry row."""
        return sum(w for _, w in self._pack_fields()), self.L + 3

    def _unpack(self, packf: np.ndarray, packi: np.ndarray) -> dict:
        L = self.L
        sl, pos = {}, 0
        for name, w in self._pack_fields():
            sl[name] = packf[..., pos:pos + w] if w > 1 else packf[..., pos]
            pos += w
        sl["loc"] = packi[..., :L]
        sl["k_c"] = packi[..., L]
        sl["n_u"] = packi[..., L + 1]
        sl["bandok"] = packi[..., L + 2]
        return sl

    def _count(self, nsteps: int) -> int:
        """Super-steps of ``nsteps`` periods (a multiple of L); blocks
        come back in the per-period (steps, C, ...) layout."""
        if nsteps % self.L:
            raise ValueError(f"nsteps must be a multiple of L={self.L}")
        return nsteps // self.L

    def _key(self) -> tuple:
        return (self._corr,)

    def run_block_collect(self, handle) -> TrackOutputs:
        """Copy a run_block_start handle to the host and rebuild the
        per-period layout; raises if any active window left the block."""
        packf, packi = self._fetch(handle)
        with self.spans("track.unpack"):
            return self._outputs(packf, packi)

    def _outputs(self, packf: np.ndarray, packi: np.ndarray
                 ) -> TrackOutputs:
        o = self._unpack(packf, packi)
        if not np.all(o["bandok"]):
            raise RuntimeError(
                f"{self._corr} correlator: an active window ran outside the "
                "sample block — the block's outputs are invalid (the caller "
                "must keep every window inside the block)")
        S = o["k_c"].shape[0]
        L, taps = self.L, self.cfg.ntaps
        C = o["k_c"].shape[1]

        def tolinear(a):
            a = np.moveaxis(a, 2, 1)            # (S, L, C, ...)
            return a.reshape((-1,) + a.shape[2:])

        steps = S * L
        kc = o["k_c"]
        upd_rows = (np.arange(S)[:, None] * L + kc)
        flagloop = np.zeros((steps, C), np.int32)
        n = np.full((steps, C), self.n_nom, np.int32)
        remcode = np.zeros((steps, C), np.float32)
        remcarr = np.zeros((steps, C), np.float32)
        sum_i = np.zeros((steps, C, taps), np.float32)
        sum_q = np.zeros((steps, C, taps), np.float32)
        cols = np.broadcast_to(np.arange(C)[None, :], (S, C))
        flagloop[upd_rows, cols] = 2
        n[upd_rows, cols] = o["n_u"]
        remcode[upd_rows, cols] = o["remcode_u"]
        remcarr[upd_rows, cols] = o["remcarr_u"]
        sum_i[upd_rows, cols] = o["sum_i_u"]
        sum_q[upd_rows, cols] = o["sum_q_u"]

        def widen(a):
            return np.repeat(a, L, axis=0)

        return TrackOutputs(
            ip=tolinear(o["ip"]), qp=tolinear(o["qp"]),
            loc=tolinear(o["loc"]), n=n, remcode=remcode, remcarr=remcarr,
            sum_i=sum_i, sum_q=sum_q,
            dcarr=widen(o["dcarr"]), dcode=widen(o["dcode"]),
            carr_err=widen(o["carr_err"]), code_err=widen(o["code_err"]),
            carr_nco=widen(o["carr_nco"]), code_nco=widen(o["code_nco"]),
            flagloopfilter=flagloop)
