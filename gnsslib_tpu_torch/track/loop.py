"""Per-period tracking: batched correlation + DLL/PLL/FLL (port of
:mod:`gnsslib_tpu.track.loop`).

The JAX package runs one ``lax.scan`` over code periods with channels
``vmap``-ed; here every channel advances at once along a written-out
channel axis, and the scan is a Python loop over periods
(:meth:`Tracker.run_steps`).  The state and constants live on the
tracker's device; nothing in the loop reads back to the host, so on a card
a block's loop is captured once in a CUDA graph and replayed per block
(:mod:`.program`, the counterpart of the jitted ``Tracker._run``).

The reference maps the cos-mixed channel to trk.QQ and the sin-mixed
channel to trk.II (argument swap at sdrtrk.c:40-43): IP = corr.imag,
QP = corr.real.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .. import codes
from ..constants import PI
from ..ops import correlator as corr_ops
from ..ops.carrier import TWO_PI
from ..ops.nco import NSPAN, frac
from .program import CARRY_FIELDS, BlockRunner
from .state import TrackConfig, TrackState, loop_interval

F32 = torch.float32
I32 = torch.int32
# code periods after a channel's start in which its carrier loop is the
# FLL alone, with no PLL gain: half of the framer's bit-sync wait (2000
# periods), so the PLL (PLLB1) joins with the frequency pulled in.  A PLL
# on from the start, as in the reference (sdrtrk.c), holds a channel
# acquired ~230 Hz or more off its carrier near the 250 Hz edge of the
# 1 ms FLL, until the loop's cadence after bit sync (2 periods for SBAS,
# 10 for GPS) locks it a Costas ambiguity (250 or 50 Hz) off: bit-synced,
# never a frame
FLL_PULLIN = 1000


@dataclasses.dataclass
class TrackOutputs:
    """Per-period telemetry, host numpy arrays shaped (steps, C, ...)."""
    ip: np.ndarray
    qp: np.ndarray
    sum_i: np.ndarray
    sum_q: np.ndarray
    loc: np.ndarray
    n: np.ndarray
    remcode: np.ndarray
    remcarr: np.ndarray
    dcarr: np.ndarray
    dcode: np.ndarray
    carr_err: np.ndarray
    code_err: np.ndarray
    carr_nco: np.ndarray
    code_nco: np.ndarray
    flagloopfilter: np.ndarray


def resolve_device(device) -> torch.device:
    """``device`` with an explicit CUDA index (``cuda`` -> ``cuda:N`` of
    the current device), so that tensor devices compare equal to it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def upload(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Host values ``x`` as a tensor on ``device``.  To a card the copy
    goes from page-locked memory and is only queued on the current
    stream: a copy from pageable memory would wait for the whole stream,
    so for every block queued before it."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Tracker(BlockRunner):
    """Tracking program for a group of channels sharing one front end.
    A block runs as a :class:`~.program.BlockProgram` (a CUDA graph on a
    card) through ``run_block``/``run_block_start``; :meth:`run_steps` is
    the eager loop it replays.  The caller guarantees max(loc) +
    nsteps*(n_nom+NSPAN) + nwin <= len(block)."""

    def __init__(self, cfg: TrackConfig, prns, ctypes, f_sf: float,
                 f_if: float, dtype: int, foffsets=None, f_cfs=None, *,
                 device):
        prns = list(prns)
        C = len(prns)
        ctypes = [int(c) for c in (ctypes if not np.isscalar(ctypes)
                                   else [ctypes] * C)]
        foffsets = np.zeros(C) if foffsets is None else np.asarray(
            foffsets, np.float64)
        if f_cfs is None:
            f_cfs = np.full(C, 1.57542e9)
        f_cfs = np.asarray(f_cfs, np.float64)

        self.device = resolve_device(device)
        self.cfg = cfg
        self.C = C
        self.f_sf = f_sf
        self.f_if = f_if
        self.dtype = int(dtype)
        self.ti = 1.0 / f_sf

        codes_list, crates, clens = [], [], []
        for prn, ct in zip(prns, ctypes):
            code, crate = codes.gencode(prn, ct)
            codes_list.append(code)
            crates.append(crate)
            clens.append(len(code))
        clen_max = max(clens)
        code_mat = np.zeros((C, clen_max), np.int8)
        for i, c in enumerate(codes_list):
            code_mat[i, :len(c)] = c
        self.crate = np.asarray(crates, np.float64)
        self._ctypes = ctypes
        self._clens = clens
        self.ctime = np.asarray(clens, np.float64) / self.crate
        nsamp = np.round(f_sf * self.ctime).astype(np.int64)
        if not np.all(nsamp == nsamp[0]):
            raise ValueError("channels in one tracker group must share the "
                             "code period")
        self.n_nom = int(nsamp[0])
        self.nwin = self.n_nom + 2 * NSPAN + 4
        self.smax = cfg.smax
        self.next = self.nwin + 2 * self.smax
        self.offsets = corr_ops.tap_offsets(cfg.corrn, cfg.corrd)

        # the same numpy construction as gnsslib_tpu's Tracker, so every
        # constant is bit-identical to the JAX package's
        i64 = np.arange(self.next, dtype=np.float64)
        ci0 = self.crate * self.ti
        ks = self.n_nom + np.arange(-NSPAN, NSPAN + 1, dtype=np.float64)
        f_base = f_if + foffsets
        self._f_base = f_base
        ph = np.mod(f_base[:, None] * self.ti * i64[None, :self.nwin], 1.0)
        self.aid = (self.crate / f_cfs).astype(np.float32)
        loops = np.asarray([loop_interval(ct) for ct in ctypes], np.int32)
        consts = dict(
            loop=loops,
            ci0=ci0.astype(np.float32),
            code_adv=(ci0[:, None] * ks[None, :]
                      - np.asarray(clens, np.float64)[:, None]
                      ).astype(np.float32),
            base_phase=ph.astype(np.float32),
            carr_adv=np.mod(f_base[:, None] * self.ti * ks[None, :], 1.0
                            ).astype(np.float32),
            aid=self.aid,
            dt1=self.ctime.astype(np.float32),
            dt2=(self.ctime * loops).astype(np.float32),
        )
        # quantized-phase replica table: rows are resampled codes at the
        # MIDPOINT phases f_q = (q+.5)*ci0/Q, paired with FLOOR
        # quantization of the phase (interval-preserving on chip-
        # commensurate grids; see gnsslib_tpu/track/loop.py)
        self._tbl_q = int(max(64, min(1024, 2 ** int(np.ceil(
            np.log2(512.0 * float(ci0.max())))))))
        self._tbl_m0 = int(np.ceil(2.0 / ci0.min())) + self.smax + 2
        W = self.next + self._tbl_m0 + int(np.ceil(2.0 / ci0.min())) + 4
        j = np.arange(W, dtype=np.float64) - self._tbl_m0
        tbl = np.empty((C, self._tbl_q, W), np.int8)
        for c in range(C):
            fq = ((np.arange(self._tbl_q, dtype=np.float64) + 0.5)
                  * ci0[c] / self._tbl_q)
            pos = fq[:, None] + ci0[c] * j[None, :]
            idx = np.floor(pos).astype(np.int64)
            if cfg.interp_replica:
                f = pos - np.floor(pos)
                v = ((1.0 - f) * code_mat[c][np.mod(idx, clens[c])]
                     + f * code_mat[c][np.mod(idx + 1, clens[c])])
                tbl[c] = np.round(127.0 * v).astype(np.int8)
            else:
                tbl[c] = code_mat[c][np.mod(idx, clens[c])]
        self._tbl_scale = (1.0 / 127.0) if cfg.interp_replica else 1.0
        consts["table"] = tbl
        consts["clen"] = np.asarray(clens, np.int32)
        self._consts = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in consts.items()}
        self._W = W
        self._index_tensors()

    def _index_tensors(self) -> None:
        """The index and coefficient tensors of the loop body on
        ``device``, and an empty program cache."""
        cfg, C, dev = self.cfg, self.C, self.device
        self._cidx = torch.arange(C, device=dev)
        self._iwin = torch.arange(self.nwin, device=dev)
        self._iwin_f = self._iwin.to(F32)
        self._inext = torch.arange(self.next, device=dev)
        self._tap_idx = (self.smax + torch.as_tensor(
            self.offsets, dtype=torch.long, device=dev)[:, None]
            + self._iwin[None, :])                         # (T, nwin)
        self._tbl_flat = self._consts["table"].reshape(-1)
        # loop coefficients as f32 rows [pllaw, pllw2, fllw, dllaw, dllw2],
        # selected per channel by the loop phase: prm1 with no PLL (the
        # first FLL_PULLIN periods), prm1, prm2 (after bit sync)
        p1, p2 = cfg.prm1, cfg.prm2
        self._prm = torch.tensor(
            [[0.0, 0.0, p1.fllw, p1.dllaw, p1.dllw2]]
            + [[p.pllaw, p.pllw2, p.fllw, p.dllaw, p.dllw2]
               for p in (p1, p2)], dtype=F32, device=dev)
        self.programs = {}       # block programs by (steps, block shape)

    def shard(self, sl: slice, device) -> "Tracker":
        """This tracker's channels ``sl`` on ``device``: the same program
        (replica table geometry, loop coefficients) over the channel slice
        of every per-channel constant, with block programs of its own (a
        shard of :class:`~..parallel.sharded.ShardedTracker`)."""
        t = copy.copy(self)
        t.device = resolve_device(device)
        t.C = len(range(self.C)[sl])
        for k in ("crate", "ctime", "aid", "_f_base", "_ctypes", "_clens"):
            setattr(t, k, getattr(self, k)[sl])
        t._consts = {k: v[sl].to(t.device) for k, v in self._consts.items()}
        t._index_tensors()
        return t

    # ------------------------------------------------------------------ #
    def init_state(self) -> TrackState:
        return TrackState.init(self.C, self.cfg.ntaps, self.device)

    def _set(self, t: torch.Tensor, idx, v) -> torch.Tensor:
        """Functional ``t.at[idx].set(v)``: a new tensor, ``t`` untouched."""
        out = t.clone()
        out[upload(np.asarray(idx, np.int64), t.device)] = \
            upload(v, t.device, t.dtype)
        return out

    def start_channels(self, state: TrackState, idx, loc, dcarr
                       ) -> TrackState:
        """Begin tracking channels ``idx`` at block offsets ``loc`` with
        acquisition carrier offsets ``dcarr`` (Hz) — the acquisition ->
        tracking handoff (sdracq.c:51-56)."""
        idx = np.asarray(idx, np.int64)
        return state.replace(
            loc=self._set(state.loc, idx, loc),
            dcarr_acq=self._set(state.dcarr_acq, idx, dcarr),
            remcode=self._set(state.remcode, idx, 0.0),
            remcarr=self._set(state.remcarr, idx, 0.0),
            carr_nco=self._set(state.carr_nco, idx, 0.0),
            code_nco=self._set(state.code_nco, idx, 0.0),
            cnt=self._set(state.cnt, idx, 0),
            active=self._set(state.active, idx, True),
        )

    def set_bit_sync(self, state: TrackState, ch: int, sync_offset: int
                     ) -> TrackState:
        """Nav bit sync for one channel: prm2 cadence with loop updates at
        cnt ≡ sync_offset (mod loop), and the code NCO restarts at the
        carrier-aided rate (drops the prm1 jitter the narrow prm2 DLL
        would otherwise inherit)."""
        return state.replace(
            flagsync=self._set(state.flagsync, [ch], True),
            sync_offset=self._set(state.sync_offset, [ch], int(sync_offset)),
            code_nco=self._set(state.code_nco, [ch], 0.0),
            code_err=self._set(state.code_err, [ch], 0.0))

    def rebase(self, state: TrackState, advance) -> TrackState:
        """Shift block-relative offsets after the host moves the block's
        first sample ``advance`` samples later: one int for every channel,
        or a (C,) array of each channel's shift."""
        if np.ndim(advance) == 0:
            return state.replace(loc=state.loc - int(advance))
        shift = upload(np.asarray(advance, np.int64), state.loc.device,
                       state.loc.dtype)
        return state.replace(loc=state.loc - shift)

    # ------------------------------------------------------------------ #
    def state_to_carry(self, s: TrackState) -> dict:
        c = {k: getattr(s, k) for k in s.__dataclass_fields__}
        c["dcps"] = (s.dcarr_acq + s.carr_nco) * self.ti
        c["dci"] = (-s.code_nco + (s.dcarr_acq + s.carr_nco)
                    * self._consts["aid"]) * self.ti
        return c

    @staticmethod
    def carry_to_state(c: dict, template: TrackState) -> TrackState:
        return template.replace(**{k: c[k] for k in CARRY_FIELDS})

    def _replica(self, remcode: torch.Tensor) -> torch.Tensor:
        """(C,) code phase -> (C, next) float32 replica over [-smax,
        nwin+smax): a contiguous slice of the quantized-phase table row,
        with the slice start clamped into the row as
        ``lax.dynamic_slice`` clamps it."""
        cc = self._consts
        Q = self._tbl_q
        phi = remcode - cc["ci0"] * self.smax
        s = phi / cc["ci0"]
        m = torch.floor(s)
        q = torch.floor((s - m) * Q).to(I32)
        m = m.to(I32) + torch.div(q, Q, rounding_mode="floor")
        q = torch.remainder(q, Q)
        start = torch.clamp(m + self._tbl_m0, 0, self._W - self.next)
        flat0 = (self._cidx * Q + q.long()) * self._W + start.long()
        return self._tbl_flat[flat0[:, None] + self._inext[None, :]].to(F32)

    def _step(self, block: torch.Tensor, st: dict):
        """One code period for every channel -> (new carry, outputs)."""
        cfg = self.cfg
        cc = self._consts
        ci = cc["ci0"] + st["dci"]
        n = torch.round((cc["clen"].to(F32) - st["remcode"]) / ci).to(I32)
        n = torch.clamp(n, self.n_nom - NSPAN, self.n_nom + NSPAN)

        # --- correlate ------------------------------------------------ #
        start = torch.clamp(st["loc"].long(), 0, block.shape[0] - self.nwin)
        win = block[start[:, None] + self._iwin[None, :]]
        ph = frac(cc["base_phase"] + frac(st["dcps"][:, None]
                                          * self._iwin_f[None, :])
                  + st["remcarr"][:, None])
        ang = TWO_PI * ph
        c, s = torch.cos(ang), torch.sin(ang)
        if win.dim() == 3:
            wr, wi = win[..., 0], win[..., 1]
            re, im = wr * c - wi * s, wr * s + wi * c
        else:
            re, im = win * c, win * s
        keep = self._iwin[None, :] < n[:, None]
        iq = torch.stack([torch.where(keep, re, 0.0),
                          torch.where(keep, im, 0.0)], dim=-1)
        reps = self._replica(st["remcode"])[:, self._tap_idx]  # (C,T,nwin)
        z = torch.bmm(reps, iq)                                # (C, T, 2)
        if self._tbl_scale != 1.0:
            z = z * self._tbl_scale
        cur_i = z[..., 1]
        cur_q = z[..., 0]

        # --- cumulative sums (sdrtrk.c:64-76) ------------------------- #
        sum_i = st["sum_i"] + cur_i
        sum_q = st["sum_q"] + cur_q
        oldsum_i = st["oldsum_i"] + st["prev_i"]
        oldsum_q = st["oldsum_q"] + st["prev_q"]

        # --- loop filter gating (sdrmain.c:271-280) ------------------- #
        cnt1 = st["cnt"] + 1
        swloop = torch.remainder(cnt1 - st["sync_offset"], cc["loop"]) == 0
        do1 = ~st["flagsync"]
        do2 = st["flagsync"] & swloop
        update = do1 | do2
        flagloop = torch.where(do1, 1, torch.where(do2, 2, 0)).to(I32)
        dt = torch.where(do1, cc["dt1"], cc["dt2"])
        row = torch.where(do1, (st["cnt"] >= FLL_PULLIN).long(), 2)
        prm = self._prm[row]
        pllaw, pllw2, fllw, dllaw, dllw2 = prm.unbind(1)

        carr_err, freq_err, code_err = discriminators(
            sum_i, sum_q, oldsum_i, oldsum_q, cfg.ne, cfg.nl)
        carr_nco_new = (st["carr_nco"] + pllaw * (carr_err - st["carr_err"])
                        + pllw2 * dt * carr_err + fllw * dt * freq_err)
        code_nco_new = (st["code_nco"] + dllaw * (code_err - st["code_err"])
                        + dllw2 * dt * code_err)

        carr_nco = torch.where(update, carr_nco_new, st["carr_nco"])
        code_nco = torch.where(update, code_nco_new, st["code_nco"])
        carr_err_c = torch.where(update, carr_err, st["carr_err"])
        code_err_c = torch.where(update, code_err, st["code_err"])
        freq_err_c = torch.where(update, freq_err, st["freq_err"])

        dcarr_hz = st["dcarr_acq"] + carr_nco
        dcode_hz = -code_nco + dcarr_hz * cc["aid"]

        # --- advance phases with the OLD rates used this period ------- #
        k = (n - self.n_nom + NSPAN).long()[:, None]
        nf = n.to(F32)
        remcode = (st["remcode"] + cc["code_adv"].gather(1, k)[:, 0]
                   + st["dci"] * nf)
        remcarr = frac(st["remcarr"] + cc["carr_adv"].gather(1, k)[:, 0]
                       + frac(st["dcps"] * nf))

        packf = torch.cat([
            cur_i[:, :1], cur_q[:, :1], sum_i, sum_q,
            torch.stack([st["remcode"], st["remcarr"], dcarr_hz, dcode_hz,
                         carr_err_c, code_err_c, carr_nco, code_nco], 1)],
            dim=1)
        packi = torch.stack([st["loc"], n, flagloop], dim=1)

        clear = update[:, None]
        new = dict(
            loc=st["loc"] + n, cnt=cnt1,
            remcode=remcode, remcarr=remcarr,
            dcps=(st["dcarr_acq"] + carr_nco) * self.ti,
            dci=(-code_nco + (st["dcarr_acq"] + carr_nco) * cc["aid"])
                * self.ti,
            carr_nco=carr_nco, code_nco=code_nco,
            carr_err=carr_err_c, code_err=code_err_c, freq_err=freq_err_c,
            sum_i=torch.where(clear, 0.0, sum_i),
            sum_q=torch.where(clear, 0.0, sum_q),
            oldsum_i=torch.where(clear, 0.0, oldsum_i),
            oldsum_q=torch.where(clear, 0.0, oldsum_q),
            prev_i=cur_i, prev_q=cur_q,
        )
        return new, packf, packi

    def run_steps(self, carry: dict, block: torch.Tensor, nsteps: int):
        """``nsteps`` periods; inactive channels freeze their whole carry.
        Returns (carry, packf (steps, C, F), packi (steps, C, 3))."""
        pf, pi = [], []
        for _ in range(int(nsteps)):
            new, packf, packi = self._step(block, carry)
            act = carry["active"]
            carry = {k: (torch.where(act.view((-1,) + (1,) * (v.dim() - 1)),
                                     new[k], v) if k in new else v)
                     for k, v in carry.items()}
            pf.append(packf)
            pi.append(packi)
        return carry, torch.stack(pf), torch.stack(pi)

    def _pack_fields(self) -> tuple:
        """The (name, width) of each float telemetry column, in order."""
        taps = self.cfg.ntaps
        return tuple(zip(
            ("ip", "qp", "sum_i", "sum_q", "remcode", "remcarr", "dcarr",
             "dcode", "carr_err", "code_err", "carr_nco", "code_nco"),
            (1, 1, taps, taps, 1, 1, 1, 1, 1, 1, 1, 1)))

    def pack_widths(self) -> tuple[int, int]:
        """The float and int columns of a channel's telemetry row."""
        return sum(w for _, w in self._pack_fields()), 3

    def _unpack_outs(self, packf: np.ndarray, packi: np.ndarray) -> dict:
        o, pos = {}, 0
        for name, w in self._pack_fields():
            o[name] = packf[..., pos] if w == 1 else packf[..., pos:pos + w]
            pos += w
        o["loc"], o["n"], o["flagloopfilter"] = (
            packi[..., 0], packi[..., 1], packi[..., 2])
        return o

    def run_block_collect(self, handle) -> TrackOutputs:
        """Copy a run_block_start handle to the host and unpack it."""
        packf, packi = self._fetch(handle)
        with self.spans("track.unpack"):
            return TrackOutputs(**self._unpack_outs(packf, packi))


def discriminators(sum_i, sum_q, oldsum_i, oldsum_q, ne: int, nl: int):
    """PLL/FLL (sdrtrk.c:94-125) and DLL (sdrtrk.c:133-150)
    discriminators on accumulated taps (..., T) -> (carr_err, freq_err,
    code_err), each (...,)."""
    IP, QP = sum_i[..., 0], sum_q[..., 0]
    oIP, oQP = oldsum_i[..., 0], oldsum_q[..., 0]
    carr_err = torch.where(IP > 0, torch.atan2(QP, IP),
                           torch.atan2(-QP, -IP)) / PI
    f1 = torch.where(IP == 0, PI / 2,
                     torch.atan(QP / torch.where(IP == 0, 1.0, IP)))
    f2 = torch.where(oIP == 0, PI / 2,
                     torch.atan(oQP / torch.where(oIP == 0, 1.0, oIP)))
    freq_err = f1 - f2
    freq_err = torch.where(freq_err > PI / 2, PI - freq_err, freq_err)
    freq_err = torch.where(freq_err < -PI / 2, -PI - freq_err, freq_err)
    IE, QE = sum_i[..., ne], sum_q[..., ne]
    IL, QL = sum_i[..., nl], sum_q[..., nl]
    eE = torch.sqrt(IE * IE + QE * QE)
    eL = torch.sqrt(IL * IL + QL * QL)
    code_err = (eE - eL) / torch.clamp(eE + eL, min=1e-12)
    return carr_err, freq_err, code_err
