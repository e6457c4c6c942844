"""Batched FFT acquisition search (port of
:mod:`gnsslib_tpu.acquire.search`).

Reference behavior (src/sdracq.c:14-95, sdrcmn.c:723-773): per round, mix
each Doppler bin, FFT-correlate against the code spectrum, accumulate
|corr|² non-coherently; accept when (global peak)/(second peak outside ±2
chips) > ACQTH; C/N0 = 10·log10(maxP / meanP / ctime).

The JAX package maps one channel at a time (``lax.map``); here channels
run in chunks sized by a byte budget, which bounds memory the same way
while giving the card larger FFT batches.  The coarse/fine search (cumsum
rebin onto a power-of-two grid, then a full-rate refine at the winning
Doppler bin) and the even/odd round accumulators are unchanged.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import codes
from ..constants import ACQHBAND, ACQINTG_L1CA, ACQSTEP, ACQTH
from ..ops import fftcorr, stats
from ..ops.carrier import TWO_PI
from ..ops.nco import frac
from ..track.loop import resolve_device

F32 = torch.float32
# bytes of (rounds x Doppler x nfft) complex64 mixing grid per channel
# chunk; FFT temporaries add about three more of the same
CHUNK_BYTES = 192e6


@dataclasses.dataclass
class AcqResult:
    """Per-channel acquisition outcome (arrays of shape (C,))."""
    acquired: np.ndarray   # bool
    codei: np.ndarray      # code-phase sample offset in [0, nsamp)
    freqi: np.ndarray      # Doppler bin index
    acqfreq: np.ndarray    # acquired absolute carrier frequency (Hz)
    dcarr: np.ndarray      # acqfreq - (f_if + foffset)  (Hz)
    cn0: np.ndarray        # C/N0 estimate (dB-Hz)
    peakr: np.ndarray      # first/second peak ratio
    confirmed: np.ndarray  # even/odd-round peak agreement (bool)
    P: torch.Tensor | None = None  # (C, F, nsamp_d) power surface on the
                           # device, on the SEARCH grid: full-rate samples
                           # when coarse is off, else cells of ``scale``
                           # samples (``codei`` is always full-rate); only
                           # with search_dev(diag=True), the pltacq view
                           # (src/sdrmain.c:258)


def _rot(ph: torch.Tensor) -> torch.Tensor:
    """exp(2πj·ph) as complex64, with the f32 angle 2π·ph."""
    ang = TWO_PI * ph
    return torch.complex(torch.cos(ang), torch.sin(ang))


class Acquirer:
    """Acquisition program for a group of channels sharing one front end
    (same f_sf / f_if / dtype / nsamp), with the reference's search
    settings: ±ACQHBAND Hz in ACQSTEP bins, ACQINTG_L1CA rounds, peak
    ratio > ACQTH (sdrinit.c:385-394, 623-653), and the JAX package's
    automatic coarse grid (>= 4 cells per chip).  ``confirm`` (ACQCONFIRM)
    also requires the even- and odd-round halves to agree on the peak
    (``confirm_impl``), the JAX package's false-lock guard."""

    def __init__(self, prns, ctypes, f_sf: float, f_if: float, dtype: int,
                 foffsets=None, *, device, confirm: bool = False):
        from ..constants import DType
        prns = list(prns)
        C = len(prns)
        ctypes = list(ctypes) if not np.isscalar(ctypes) else [ctypes] * C
        foffsets = np.zeros(C) if foffsets is None else np.asarray(
            foffsets, np.float64)
        self.device = resolve_device(device)
        self.C = C
        self.f_sf = f_sf
        self.f_if = f_if
        self.dtype = dtype
        self.iq = int(dtype) == DType.IQ
        self.ti = 1.0 / f_sf
        self.intg = ACQINTG_L1CA
        self.thresh = ACQTH
        self.confirm = bool(confirm)
        self.nfreq = int(2 * (ACQHBAND / ACQSTEP) + 1)

        code0, crate0 = codes.gencode(prns[0], ctypes[0])
        self.ctime = len(code0) / crate0
        self.nsamp = int(round(f_sf * self.ctime))

        clens = [len(codes.gencode(p, c)[0]) for p, c in zip(prns, ctypes)]
        ngrid = fftcorr.next_pow2(4 * max(clens))
        self.coarse = ngrid < self.nsamp
        self.nsamp_d = ngrid if self.coarse else self.nsamp
        self.scale = self.nsamp / self.nsamp_d
        self.refine_rad = int(np.ceil(1.5 * self.scale)) + 1
        self.nfft = (self.nsamp_d if self.coarse
                     else fftcorr.next_pow2(2 * self.nsamp))

        # the same numpy construction as the JAX package's Acquirer
        codex = np.empty((C, self.nfft), np.complex64)
        code_fr = np.empty((C, self.nsamp), np.float32)
        nsampchip = np.empty(C, np.int32)
        for i, (prn, ct) in enumerate(zip(prns, ctypes)):
            code, crate = codes.gencode(prn, ct)
            clen = len(code)
            nsampchip[i] = max(1, int(self.nsamp_d / clen))
            idx = np.mod(np.floor(np.arange(self.nsamp_d, dtype=np.float64)
                                  * self.scale * crate / f_sf)
                         .astype(np.int64), clen)
            rc = np.zeros(self.nfft, np.float32)
            rc[:self.nsamp_d] = code[idx]
            codex[i] = np.conj(np.fft.fft(rc)).astype(np.complex64)
            idx_fr = np.mod(np.floor(np.arange(self.nsamp, dtype=np.float64)
                                     * crate / f_sf).astype(np.int64), clen)
            code_fr[i] = code[idx_fr]
        nwin = 2 * self.nsamp
        i64 = np.arange(nwin, dtype=np.float64)
        base = np.mod((f_if + foffsets)[:, None] * self.ti * i64[None, :],
                      1.0)
        k = np.arange(self.nfreq, dtype=np.float64) - (self.nfreq - 1) / 2
        self.dopp_hz = k * ACQSTEP
        self.freqs_abs = (f_if + foffsets[:, None] + self.dopp_hz[None, :])
        dev = self.device
        self._consts = dict(
            codex=torch.from_numpy(codex).to(dev),
            nsampchip=torch.from_numpy(nsampchip).to(dev),
            base_phase=torch.from_numpy(base.astype(np.float32)).to(dev),
            d_cps=torch.from_numpy((k * ACQSTEP * self.ti).astype(
                np.float32)).to(dev),
        )
        if self.coarse:
            self._consts["code_fr"] = torch.from_numpy(code_fr).to(dev)
            edges = np.round(np.arange(1, self.nsamp_d + 1, dtype=np.float64)
                             * self.scale).astype(np.int64) - 1
            edges[-1] = self.nsamp - 1
            self._consts["edges"] = torch.from_numpy(edges).to(dev)
        # consts with a leading channel axis (gathered for subset searches)
        self.ch_const_keys = [k for k in self._consts
                              if k not in ("d_cps", "edges")]
        per_ch = self.intg * self.nfreq * self.nfft * 8
        self.chunk = max(1, int(CHUNK_BYTES // per_ch))

    # -- device program ------------------------------------------------------
    def _complex(self, x: torch.Tensor) -> torch.Tensor:
        if self.iq:
            return torch.complex(x[..., 0], x[..., 1])
        return x.to(torch.complex64)

    def _power_chunk(self, rounds: torch.Tensor, consts: dict, sl: slice):
        """Even/odd accumulated power (c, 2, F, nsamp_d) for channels
        ``sl`` of ``consts``."""
        d_cps = consts["d_cps"]
        base = consts["base_phase"][sl]                     # (c, 2*nsamp)
        codex = consts["codex"][sl]                         # (c, nfft)
        ng = self.nsamp_d
        if not self.coarse:
            nwin = 2 * self.nsamp
            i = torch.arange(nwin, dtype=F32, device=rounds.device)
            ph = base[:, None, :] + frac(d_cps[:, None] * i)[None]
            rot = _rot(ph)                                  # (c, F, nwin)
            d = self._complex(rounds[:, :nwin])             # (R, nwin)
            mixed = d[None, :, None, :] * rot[:, None]      # (c, R, F, nwin)
            mixed = torch.nn.functional.pad(mixed, (0, self.nfft - nwin))
        else:
            rot = _rot(base[:, :self.nsamp])                # (c, nsamp)
            dc = self._complex(rounds[:, :self.nsamp])[None] * rot[:, None]
            cs = torch.cumsum(dc, dim=-1)                   # (c, R, nsamp)
            at = cs[..., consts["edges"]]                   # (c, R, ng)
            dd = at - torch.nn.functional.pad(at[..., :-1], (1, 0))
            i_d = torch.arange(ng, dtype=F32, device=rounds.device)
            rotd = _rot(frac((d_cps * self.scale)[:, None] * i_d[None, :]))
            mixed = dd[:, :, None, :] * rotd[None, None]    # (c, R, F, ng)
        p = fftcorr.fft_correlate_power(mixed, codex[:, None, None, :],
                                        self.nsamp_d)       # (c, R, F, n)
        return torch.stack([p[:, 0::2].sum(dim=1), p[:, 1::2].sum(dim=1)],
                           dim=1)

    def _power(self, rounds: torch.Tensor, consts: dict) -> torch.Tensor:
        C = consts["base_phase"].shape[0]
        return torch.cat([
            self._power_chunk(rounds, consts, slice(c0, c0 + self.chunk))
            for c0 in range(0, C, self.chunk)])

    def _refine(self, rounds: torch.Tensor, consts: dict, codei_d, freqi):
        """Full-rate code phase at the winning Doppler bin: correlate the
        full-rate rounds with the replica at the 2*refine_rad+1 lags around
        the coarse cell's center and take the argmax (the exact-cell answer
        of the undecimated search)."""
        rad = self.refine_rad
        nsamp = self.nsamp
        nb = nsamp + 2 * rad
        dev = rounds.device
        out = []
        C = codei_d.shape[0]
        j = torch.arange(2 * nsamp, dtype=F32, device=dev)
        for c0 in range(0, C, self.chunk):
            sl = slice(c0, c0 + self.chunk)
            ci_d, fi = codei_d[sl], freqi[sl]
            cf = torch.round(ci_d.to(F32) * float(np.float32(self.scale))).to(
                torch.int32)
            s = torch.remainder(cf - rad, nsamp)             # (c,)
            ph = consts["base_phase"][sl] + frac(
                consts["d_cps"][fi.long()][:, None] * j[None, :])
            y = self._complex(rounds)[None] * _rot(ph)[:, None]  # (c,R,2n)
            ybig = torch.cat([y, y[..., :2 * rad]], dim=-1)
            cols = s.long()[:, None] + torch.arange(nb, device=dev)[None]
            base = torch.gather(
                ybig, 2, cols[:, None, :].expand(-1, ybig.shape[1], -1))
            code = consts["code_fr"][sl]                     # (c, nsamp)
            win_r = base.real.unfold(-1, nsamp, 1)           # (c,R,nlag,n)
            win_i = base.imag.unfold(-1, nsamp, 1)
            zr = torch.einsum("crlk,ck->crl", win_r, code)
            zi = torch.einsum("crlk,ck->crl", win_i, code)
            pw = (zr * zr + zi * zi).sum(dim=1)              # (c, nlag)
            out.append(torch.remainder(
                s + torch.argmax(pw, dim=-1).to(torch.int32), nsamp))
        return torch.cat(out)

    def confirm_impl(self, Ph: torch.Tensor, nsampchip: torch.Tensor):
        """Even/odd-half peak agreement: (C, 2, F, n) -> (C,) bool."""
        C, _, F, n = Ph.shape
        if self.intg < 2:
            return torch.ones((C,), dtype=torch.bool, device=Ph.device)

        def peak(P):
            maxi = torch.argmax(P.reshape(C, F * n), dim=-1)
            return maxi % n, maxi // n
        ce, fe = peak(Ph[:, 0])
        co, fo = peak(Ph[:, 1])
        d = torch.abs(ce - co)
        d = torch.minimum(d, n - d)
        return (d <= 2 * nsampchip) & (torch.abs(fe - fo) <= 1)

    def check_impl(self, P: torch.Tensor, nsampchip: torch.Tensor):
        """Vectorized checkacquisition (reference src/sdracq.c:71-95)."""
        C, F, n = P.shape
        flat = P.reshape(C, F * n)
        maxi = torch.argmax(flat, dim=-1)
        maxP = torch.gather(flat, 1, maxi[:, None])[:, 0]
        codei = (maxi % n).to(torch.int32)
        freqi = (maxi // n).to(torch.int32)
        row = P[torch.arange(C, device=P.device), freqi.long()]
        lo = torch.remainder(codei - 2 * nsampchip, n)
        hi = torch.remainder(codei + 2 * nsampchip, n)
        mask = stats.exclusion_mask(n, lo, hi)
        meanP = stats.masked_mean(row, mask)
        maxP2, _ = stats.masked_max(row, mask)
        cn0 = 10.0 * torch.log10(maxP / meanP / self.ctime)
        peakr = maxP / maxP2
        return codei, freqi, cn0, peakr

    def _search_rounds(self, rounds: torch.Tensor, consts: dict):
        """(intg, 2*nsamp[, 2]) windows -> the power surface P (C, F,
        nsamp_d) and the device decision vectors."""
        Ph = self._power(rounds, consts)
        P = Ph[:, 0] + Ph[:, 1]
        codei, freqi, cn0, peakr = self.check_impl(P, consts["nsampchip"])
        if self.coarse:
            codei = self._refine(rounds, consts, codei, freqi)
        return (P, codei, freqi, cn0, peakr,
                self.confirm_impl(Ph, consts["nsampchip"]))

    def _rounds_from_flat(self, data: torch.Tensor) -> torch.Tensor:
        """Stack the (intg, 2*nsamp) round windows of a flat block, with
        the starts clamped into the block as ``lax.dynamic_slice``
        clamps them."""
        nwin = 2 * self.nsamp
        last = max(0, data.shape[0] - nwin)
        return torch.stack([data[min(r * self.nsamp, last):
                                 min(r * self.nsamp, last) + nwin]
                            for r in range(self.intg)])

    # -- receiver API --------------------------------------------------------
    def search_dev_start(self, block: torch.Tensor, idx=None,
                         diag: bool = False):
        """Queue a search over a device-resident float32 block (first
        (intg+1)*nsamp samples used) without reading the decisions back.

        ``idx``: optional pending-channel subset, padded to the next
        power-of-two bucket >= 4 (the JAX package's compile-variant bound;
        kept so both packages search the same channel sets); the others
        come back unacquired.  ``diag`` searches every channel (``idx`` is
        ignored) and keeps the power surface on the device in the handle
        (``AcqResult.P``)."""
        consts = self._consts
        if idx is not None and len(idx) < self.C and not diag:
            bucket = 4
            while bucket < len(idx):
                bucket *= 2
            if bucket >= self.C:
                idx = None
            else:
                idx = np.asarray(idx, np.int64)
                idxp = torch.as_tensor(np.concatenate(
                    [idx, np.repeat(idx[:1], bucket - len(idx))]),
                    device=self.device)
                consts = {k: (v[idxp] if k in self.ch_const_keys else v)
                          for k, v in consts.items()}
        else:
            idx = None
        rounds = self._rounds_from_flat(block)
        P, *vecs = self._search_rounds(rounds, consts)
        return (P if diag else None, *vecs, idx)

    def search_dev_collect(self, handle) -> AcqResult:
        """Copy a search_dev_start handle's decision vectors to the host
        -> AcqResult (with the handle's device surface as ``P``)."""
        P, *vecs, idx = handle
        codei, freqi, cn0, peakr, confirmed = [v.cpu().numpy() for v in vecs]
        if idx is not None:
            n = len(idx)
            full = [np.zeros(self.C, a.dtype) for a in
                    (codei, freqi, cn0, peakr, confirmed)]
            for f, a in zip(full, (codei, freqi, cn0, peakr, confirmed)):
                f[idx] = a[:n]           # peakr 0 elsewhere -> unacquired
            codei, freqi, cn0, peakr, confirmed = full
        res = self.postprocess(codei, freqi, cn0, peakr, confirmed)
        res.P = P
        return res

    def search_dev(self, block: torch.Tensor, idx=None,
                   diag: bool = False) -> AcqResult:
        return self.search_dev_collect(self.search_dev_start(block, idx,
                                                             diag))

    def stack_rounds(self, data: np.ndarray) -> np.ndarray:
        """(n[, 2]) samples -> (intg, 2*nsamp[, 2]) overlapping windows
        (complex input converted to stacked I/Q on the host)."""
        data = np.asarray(data)
        if np.iscomplexobj(data):
            data = np.stack([data.real, data.imag], axis=-1)
        data = data.astype(np.float32)
        nwin = 2 * self.nsamp
        return np.stack([data[r * self.nsamp: r * self.nsamp + nwin]
                         for r in range(self.intg)])

    def postprocess(self, codei, freqi, cn0, peakr, confirmed) -> AcqResult:
        """Decision vectors -> AcqResult (acceptance rules in one place)."""
        codei = np.asarray(codei)
        freqi = np.asarray(freqi)
        acqfreq = self.freqs_abs[np.arange(self.C), freqi]
        dcarr = self.dopp_hz[freqi]
        peakr = np.asarray(peakr)
        acquired = peakr > self.thresh
        if self.confirm:
            acquired = acquired & np.asarray(confirmed)
        return AcqResult(acquired=acquired, codei=codei,
                         freqi=freqi, acqfreq=acqfreq, dcarr=dcarr,
                         cn0=np.asarray(cn0), peakr=peakr,
                         confirmed=np.asarray(confirmed))

    def search(self, data: np.ndarray) -> AcqResult:
        """Full acquisition over (intg+1) ms of host samples."""
        rounds = torch.from_numpy(self.stack_rounds(data)).to(self.device)
        return self.postprocess(*[
            v.cpu().numpy() for v in self._search_rounds(rounds,
                                                         self._consts)[1:]])
