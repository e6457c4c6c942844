"""Tracking state and configuration (port of
:mod:`gnsslib_tpu.track.state`).

``TrackState`` holds torch tensors with a leading channel axis.  It is
treated as immutable: every update builds new tensors (clone, then write),
so a state an in-flight block still reads is never changed under it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import LOOP_G1, LOOP_L1CA, LOOP_SBAS, CodeType


@dataclasses.dataclass(frozen=True)
class LoopParams:
    """2nd-order loop coefficients from noise bandwidths (sdrinit.c:400-423:
    w2 = (B/0.53)², aw = 1.414*(B/0.53) for DLL and PLL; FLL w = B/0.25)."""
    dllw2: float
    dllaw: float
    pllw2: float
    pllaw: float
    fllw: float

    @staticmethod
    def from_bandwidths(dllb: float, pllb: float, fllb: float) -> "LoopParams":
        return LoopParams(
            dllw2=(dllb / 0.53) ** 2,
            dllaw=1.414 * (dllb / 0.53),
            pllw2=(pllb / 0.53) ** 2,
            pllaw=1.414 * (pllb / 0.53),
            fllw=fllb / 0.25,
        )


def loop_interval(ctype: int) -> int:
    """Loop-filter interval in code periods after bit sync (sdr.h:151-154)."""
    if ctype == CodeType.L1SBAS:
        return LOOP_SBAS
    if ctype == CodeType.G1:
        return LOOP_G1
    return LOOP_L1CA


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static tracking configuration for one channel group (the [TRACK]
    section of the front-end INI, reference sdrinit.c:160-169, 432-480).

    The replica is always the quantized-phase table and bit sync always
    resets the code NCO — the JAX package's defaults (``resample="table"``,
    ``reset_nco_on_sync=True``), which no configuration changes;
    ``interp_replica`` (INTERPREPLICA) keeps its meaning.
    """
    corrn: int = 6
    corrd: int = 3
    corrp: int = 6
    prm1: LoopParams = LoopParams.from_bandwidths(5.0, 30.0, 200.0)
    prm2: LoopParams = LoopParams.from_bandwidths(1.0, 10.0, 50.0)
    interp_replica: bool = False

    @property
    def ntaps(self) -> int:
        return 1 + 2 * self.corrn

    @property
    def smax(self) -> int:
        return self.corrn * self.corrd

    @property
    def ne(self) -> int:
        return 2 * (self.corrp // self.corrd) - 1

    @property
    def nl(self) -> int:
        return 2 * (self.corrp // self.corrd)


# field -> (dtype, per-channel width: None for (C,), "taps" for (C, ntaps))
_FIELDS = {
    "loc": (torch.int32, None), "cnt": (torch.int32, None),
    "remcode": (torch.float32, None), "remcarr": (torch.float32, None),
    "dcarr_acq": (torch.float32, None), "carr_nco": (torch.float32, None),
    "carr_err": (torch.float32, None), "freq_err": (torch.float32, None),
    "code_nco": (torch.float32, None), "code_err": (torch.float32, None),
    "sum_i": (torch.float32, "taps"), "sum_q": (torch.float32, "taps"),
    "oldsum_i": (torch.float32, "taps"), "oldsum_q": (torch.float32, "taps"),
    "prev_i": (torch.float32, "taps"), "prev_q": (torch.float32, "taps"),
    "flagsync": (torch.bool, None), "sync_offset": (torch.int32, None),
    "active": (torch.bool, None),
}
STATE_FIELDS = tuple(_FIELDS)


@dataclasses.dataclass(frozen=True)
class TrackState:
    """Per-channel loop state, tensors shaped (C,) or (C, ntaps) — the
    reference's sdrtrk_t fields (src/sdr.h:371-412)."""
    loc: torch.Tensor        # (C,) int32 sample offset of next period
    cnt: torch.Tensor        # (C,) int32 code periods since track start
    remcode: torch.Tensor    # (C,) f32 chips
    remcarr: torch.Tensor    # (C,) f32 cycles in [0, 1)
    dcarr_acq: torch.Tensor  # (C,) f32 Hz acquisition offset
    carr_nco: torch.Tensor   # (C,) f32 Hz
    carr_err: torch.Tensor   # (C,) f32 half-cycles
    freq_err: torch.Tensor   # (C,) f32 rad
    code_nco: torch.Tensor   # (C,) f32 Hz
    code_err: torch.Tensor   # (C,) f32
    sum_i: torch.Tensor      # (C, ntaps) f32 coherent accumulation
    sum_q: torch.Tensor
    oldsum_i: torch.Tensor   # (C, ntaps) f32 previous accumulation (FLL)
    oldsum_q: torch.Tensor
    prev_i: torch.Tensor     # (C, ntaps) f32 previous period taps
    prev_q: torch.Tensor
    flagsync: torch.Tensor   # (C,) bool nav bit sync achieved
    sync_offset: torch.Tensor  # (C,) int32 bit-phase offset
    active: torch.Tensor     # (C,) bool channel is tracking

    @staticmethod
    def init(C: int, ntaps: int, device) -> "TrackState":
        return TrackState(**{
            k: torch.zeros((C,) if w is None else (C, ntaps), dtype=dt,
                           device=device)
            for k, (dt, w) in _FIELDS.items()})

    def replace(self, **fields) -> "TrackState":
        return dataclasses.replace(self, **fields)


def state_from_numpy(d: dict, device) -> TrackState:
    """TrackState from numpy arrays keyed by the JAX ``TrackState`` field
    names (a JAX receiver checkpoint's ``state`` or ``Tracker.
    _state_to_dict``; extra keys such as ``dcps``/``dci`` are ignored)."""
    return TrackState(**{
        k: torch.tensor(np.array(d[k]), dtype=dt, device=device)
        for k, (dt, _) in _FIELDS.items()})


def state_to_numpy(state: TrackState) -> dict:
    """numpy arrays keyed by the JAX ``TrackState`` field names."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
