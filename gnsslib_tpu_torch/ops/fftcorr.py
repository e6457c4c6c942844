"""FFT-based parallel code-phase correlation (port of
:mod:`gnsslib_tpu.ops.fftcorr`); the FFTs are ``torch.fft`` (cuFFT on the
card), as the JAX package leaves its FFTs to XLA."""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def code_fft_conj(code_resampled: torch.Tensor, nfft: int):
    """conj(FFT(zero-padded resampled code))."""
    n = code_resampled.shape[-1]
    padded = torch.nn.functional.pad(code_resampled.to(torch.float32),
                                     (0, nfft - n))
    spec = torch.fft.fft(padded).to(torch.complex64)
    return torch.conj(spec).resolve_conj()


def fft_correlate_power(mixed: torch.Tensor, codex_conj: torch.Tensor,
                        nout: int):
    """|IFFT(FFT(mixed)·codex_conj)|² over the first ``nout`` lags, divided
    by nfft² like the reference (src/sdrcmn.c:244-250)."""
    nfft = mixed.shape[-1]
    spec = torch.fft.fft(mixed)
    corr = torch.fft.ifft(spec * codex_conj)
    p = (corr.real ** 2 + corr.imag ** 2)[..., :nout]
    return (p / (float(nfft) ** 2)).to(torch.float32)
