"""IF spectrum and sample-histogram diagnostics (port of
:mod:`gnsslib_tpu.diag.spectrum`).

Reference: src/sdrspec.c — 3-bit sample histogram (calchistgram :170) and
a Welch-style power spectrum from ``SPEC_NLOOP`` random-offset Hanning
windows of ``SPEC_NFFT`` points (spectrumanalyzer :232).  The histogram is
a host copy of the JAX package's; the spectrum draws the same window
offsets (numpy ``default_rng(seed)``), uploads the span once and gathers
its windows on the device by an offset index, then runs one batched FFT
there (``torch.fft``, as the JAX package runs ``jnp.fft``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SPEC_NFFT, SPEC_NLOOP


def sample_histogram(x: np.ndarray, nbit: int = 3):
    """Histogram of quantized sample values (reference 3-bit view).

    Returns (edges, counts) over the symmetric integer range of nbit.
    """
    lim = 2 ** (nbit - 1)
    edges = np.arange(-lim, lim + 1)
    flat = np.asarray(x, np.float64).ravel()
    counts, _ = np.histogram(np.clip(flat, -lim, lim - 1), bins=edges + 0.0)
    return edges[:-1], counts


def window_offsets(n: int, nfft: int, nloop: int, seed: int) -> np.ndarray:
    """The ``nloop`` window starts in a span of ``n`` samples (the JAX
    package's draw, so both packages window the same samples)."""
    if n < nfft:
        raise ValueError("need at least nfft samples")
    rng = np.random.default_rng(seed)
    return rng.integers(0, n - nfft + 1, size=nloop)


def hanning(nfft: int, device) -> torch.Tensor:
    """numpy's Hanning window as float32 on ``device``."""
    return torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(device)


def power_db(span: torch.Tensor, offs: torch.Tensor, han: torch.Tensor,
             iq: bool) -> torch.Tensor:
    """The averaged power spectrum in dB of the windows [o, o + nfft) of
    ``span`` ((n,) real or (n, 2) I/Q float32), one per offset in ``offs``,
    each weighted by ``han``; on the tensors' device, in the current
    stream.  Real input keeps the first nfft/2 bins, I/Q all nfft in FFT
    order."""
    nfft = han.shape[0]
    idx = offs[:, None] + torch.arange(nfft, device=span.device)[None]
    w = span[idx]                                     # (nloop, nfft[, 2])
    if iq:
        spec = torch.fft.fft(torch.complex(w[..., 0], w[..., 1]) * han)
    else:
        spec = torch.fft.rfft(w * han)[:, :nfft // 2]
    p = (spec.real.square() + spec.imag.square()).mean(dim=0)
    return 10.0 * torch.log10(torch.clamp(p, min=1e-30))


def spectrum_axis(p_db: np.ndarray, f_sf: float, nfft: int, iq: bool):
    """(freq_hz, p_db) of :func:`power_db`'s bins on the reference's
    display range (sdrspec.c:96-101): real [0, f_sf/2); I/Q
    [-f_sf/2, f_sf/2), fftshifted."""
    if iq:
        return ((np.arange(nfft) - nfft // 2) * (f_sf / nfft),
                np.fft.fftshift(p_db))
    return np.arange(nfft // 2) * (f_sf / nfft), p_db


def welch_spectrum(x: np.ndarray, f_sf: float, iq: bool = False,
                   nfft: int = SPEC_NFFT, nloop: int = SPEC_NLOOP,
                   seed: int = 0, *, device):
    """Averaged Hanning-windowed power spectrum in dB, computed on
    ``device``.

    Returns (freq_hz, pspec_db).  Real sampling: [0, f_sf/2); I/Q:
    [-f_sf/2, f_sf/2) (fftshifted), matching the reference's display
    ranges (sdrspec.c:96-101).
    """
    x = np.ascontiguousarray(x, np.float32)
    offs = window_offsets(x.shape[0], nfft, nloop, seed)
    p_db = power_db(torch.from_numpy(x).to(device),
                    torch.from_numpy(offs).to(device),
                    hanning(nfft, device), iq)
    return spectrum_axis(p_db.cpu().numpy(), f_sf, nfft, iq)
