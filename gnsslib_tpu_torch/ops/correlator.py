"""Multi-tap E/P/L correlator (port of :mod:`gnsslib_tpu.ops.correlator`).

Tap order matches the reference (src/sdrcmn.c:712-715): ``[P, E1, L1, E2,
L2, ...]`` with E_k at -k*corrd samples and L_k at +k*corrd samples.
"""
from __future__ import annotations

import numpy as np
import torch


def tap_offsets(corrn: int, corrd: int) -> np.ndarray:
    """Sample offsets per tap in reference order [P, E1, L1, E2, L2, ...]."""
    offs = [0]
    for k in range(1, corrn + 1):
        offs += [-k * corrd, +k * corrd]
    return np.asarray(offs, dtype=np.int32)


def dll_tap_indices(corrn: int, corrd: int, corrp: int) -> tuple[int, int]:
    """(ne, nl) tap indices used by the DLL (reference sdrinit.c:444-450)."""
    k = corrp // corrd
    return 2 * k - 1, 2 * k


def tap_windows(code_ext: torch.Tensor, offsets, smax: int, nwin: int):
    """(..., ntaps, nwin) tap-shifted replicas: tap t is
    ``code_ext[..., smax+o_t : smax+o_t+nwin]``."""
    idx = (smax + torch.as_tensor(np.asarray(offsets), dtype=torch.long,
                                  device=code_ext.device)[:, None]
           + torch.arange(nwin, device=code_ext.device)[None, :])
    return code_ext[..., idx]


def correlate_taps(mixed: torch.Tensor, code_ext: torch.Tensor, offsets,
                   smax: int, nvalid):
    """Correlate carrier-wiped data against tap-shifted code replicas.

    mixed:    (..., nwin) complex64 carrier-wiped samples.
    code_ext: (..., nwin + 2*smax) float32 replica over [-smax, nwin+smax).
    nvalid:   valid samples this period (int or tensor broadcastable to
              the batch); the tail is masked.
    Returns (..., ntaps) complex64.
    """
    nwin = mixed.shape[-1]
    i = torch.arange(nwin, device=mixed.device)
    nv = torch.as_tensor(nvalid, device=mixed.device)
    keep = i < nv[..., None]
    re = torch.where(keep, mixed.real, 0.0)
    im = torch.where(keep, mixed.imag, 0.0)
    reps = tap_windows(code_ext, offsets, smax, nwin)        # (..., T, n)
    iq = torch.stack([re, im], dim=-1)                       # (..., n, 2)
    out = reps @ iq                                          # (..., T, 2)
    return torch.complex(out[..., 0], out[..., 1])
