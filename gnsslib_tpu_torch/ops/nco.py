"""Numerically exact NCO base tables for carrier and code phase.

Port of :mod:`gnsslib_tpu.ops.nco`.  Every large-magnitude phase ramp is
precomputed on the host in float64 and stored as small float32 tables, so
the device only adds O(1) float32 corrections before a ``frac``/``floor``.
The tables are built by the same numpy code as the JAX package, so they
are bit-identical.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# how far one code period's sample count may deviate from nominal
NSPAN = 2  # n in [n_nom - NSPAN, n_nom + NSPAN]


@dataclasses.dataclass(frozen=True)
class CarrierTables:
    """Host-precomputed carrier phase ramps for one channel config."""
    base_phase: torch.Tensor     # (nwin,) f32, frac(f_base*ti*i) cycles
    adv_cycles: torch.Tensor     # (2*NSPAN+1,) f32, frac(f_base*ti*(n_nom+k))
    n_nom: int
    ti: float

    @staticmethod
    def build(f_base: float, ti: float, nwin: int, n_nom: int,
              device: torch.device) -> "CarrierTables":
        i = np.arange(nwin, dtype=np.float64)
        base = np.mod(f_base * ti * i, 1.0).astype(np.float32)
        ks = n_nom + np.arange(-NSPAN, NSPAN + 1, dtype=np.float64)
        adv = np.mod(f_base * ti * ks, 1.0).astype(np.float32)
        return CarrierTables(torch.from_numpy(base).to(device),
                             torch.from_numpy(adv).to(device), n_nom, ti)


@dataclasses.dataclass(frozen=True)
class CodeTables:
    """Host-precomputed code-phase ramps for one channel config."""
    chip_int: torch.Tensor       # (next,) int32, floor(ci0*i)
    chip_frac: torch.Tensor      # (next,) f32, ci0*i - floor(ci0*i)
    adv_chips: torch.Tensor      # (2*NSPAN+1,) f32, ci0*(n_nom+k) - clen
    n_nom: int
    clen: int
    ci0: float
    ti: float

    @staticmethod
    def build(crate: float, ti: float, next_: int, n_nom: int, clen: int,
              device: torch.device) -> "CodeTables":
        ci0 = crate * ti
        i = np.arange(next_, dtype=np.float64) * ci0
        ii = np.floor(i)
        ks = n_nom + np.arange(-NSPAN, NSPAN + 1, dtype=np.float64)
        adv = (ci0 * ks - clen).astype(np.float32)
        return CodeTables(
            torch.from_numpy(ii.astype(np.int32)).to(device),
            torch.from_numpy((i - ii).astype(np.float32)).to(device),
            torch.from_numpy(adv).to(device),
            n_nom, clen, ci0, ti,
        )


def frac(x: torch.Tensor) -> torch.Tensor:
    """Fractional part in [0, 1)."""
    return x - torch.floor(x)


def _span_index(n: torch.Tensor, n_nom: int) -> torch.Tensor:
    return (n - n_nom + NSPAN).long()


def advance_carrier(remcarr, d_cps, n, tables: CarrierTables):
    """Carrier phase remainder after n samples: frac(rem + f*ti*n)."""
    big = tables.adv_cycles[_span_index(n, tables.n_nom)]
    small = frac(d_cps * n.to(torch.float32))
    return frac(remcarr + big + small)


def advance_code(remcode, dci, n, tables: CodeTables):
    """Code phase remainder after one period of n samples."""
    big = tables.adv_chips[_span_index(n, tables.n_nom)]
    return remcode + big + dci * n.to(torch.float32)


def period_samples(remcode, dci, tables: CodeTables):
    """Samples in the code period starting at ``remcode``: round((clen -
    remcode)/ci), clamped to the table span (round half to even, as
    ``jnp.round``)."""
    ci = tables.ci0 + dci
    n = torch.round((tables.clen - remcode) / ci).to(torch.int32)
    return torch.clamp(n, tables.n_nom - NSPAN, tables.n_nom + NSPAN)
