"""Code resampling (port of :mod:`gnsslib_tpu.ops.resample`)."""
from __future__ import annotations

import torch

from .nco import CodeTables


def code_chip_indices(next_: int, remcode, dci, smax: int,
                      tables: CodeTables):
    """Chip index (mod clen) for extended sample positions i-smax:
    base_int[i] + floor(base_frac[i] + remcode + dci*i - (ci0+dci)*smax)."""
    i = torch.arange(next_, dtype=torch.float32,
                     device=tables.chip_int.device)
    shift = remcode + dci * i - (tables.ci0 + dci) * smax
    corr = torch.floor(tables.chip_frac[:next_] + shift).to(torch.int32)
    idx = tables.chip_int[:next_] + corr
    return torch.remainder(idx, tables.clen)


def resample_code(code: torch.Tensor, idx: torch.Tensor):
    """Gather the ±1 code at precomputed chip indices -> float32 (the
    semantics of ``jnp.take(code, idx, axis=-1)``)."""
    return code[..., idx.long()].to(torch.float32)
