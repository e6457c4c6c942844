"""Carrier wipe-off (port of :mod:`gnsslib_tpu.ops.carrier`)."""
from __future__ import annotations

import torch

from .nco import CarrierTables, frac

TWO_PI = 6.283185307179586


def carrier_phase(nwin: int, d_cps, remcarr, tables: CarrierTables):
    """Phase ramp (cycles mod 1): frac(base[i] + frac(d_cps*i) + remcarr)."""
    i = torch.arange(nwin, dtype=torch.float32,
                     device=tables.base_phase.device)
    return frac(tables.base_phase[:nwin] + frac(d_cps * i) + remcarr)


def mix_carrier(data: torch.Tensor, phase_cycles: torch.Tensor):
    """``data * exp(+2πj*phase)`` as complex64; ``data`` is float32 real
    samples or complex64 I/Q (the reference's rotation sense,
    src/sdrcmn.c:652-664)."""
    ph = TWO_PI * phase_cycles
    rot = torch.complex(torch.cos(ph), torch.sin(ph))
    return (data * rot).to(torch.complex64)
