"""Masked reductions and interpolation (port of
:mod:`gnsslib_tpu.ops.stats`)."""
from __future__ import annotations

import torch


def exclusion_mask(n: int, lo, hi):
    """True where the index is OUTSIDE the circular band [lo, hi]; ``lo``
    and ``hi`` may be batched (..., ) tensors -> (..., n)."""
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, device=lo.device)
    i = torch.arange(n, dtype=torch.int32, device=lo.device)
    lo_, hi_ = lo[..., None], hi[..., None]
    plain = (i < lo_) | (i > hi_)
    wrapped = (i < lo_) & (i > hi_)
    return torch.where(lo_ <= hi_, plain, wrapped)


def masked_max(x: torch.Tensor, mask: torch.Tensor):
    """(max value, argmax) over the last axis restricted to mask."""
    xm = torch.where(mask, x, torch.full_like(x, -torch.inf))
    idx = torch.argmax(xm, dim=-1)
    val = torch.gather(xm, -1, idx[..., None])[..., 0]
    return val, idx.to(torch.int32)


def masked_mean(x: torch.Tensor, mask: torch.Tensor):
    """Mean over the last axis restricted to mask."""
    s = torch.sum(torch.where(mask, x, 0.0), dim=-1)
    c = torch.sum(mask, dim=-1).to(x.dtype)
    return s / torch.clamp(c, min=1)


def lagrange_interp(x, y, t):
    """Interpolate y(t) through the 4 nearest points of ascending x (the
    reference's interp1, src/sdrcmn.c:498-552)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    n = x.shape[0]
    k = torch.clamp(torch.searchsorted(x, t), 2, n - 2)
    idx = k[..., None] + torch.arange(-2, 2, device=x.device)
    xs = x[idx]
    ys = y[idx]
    num = t[..., None] - xs
    z = 0.0
    for i in range(4):
        s = ys[..., i]
        for j in range(4):
            if j != i:
                s = s * num[..., j] / (xs[..., i] - xs[..., j])
        z = z + s
    return z
