"""Convolutional FEC for SBAS: K=7 rate-1/2 encoder + soft Viterbi decoder.

Replaces the reference's linked ka9q-fec library (create/update/
chainback_viterbi27_port — used at src/sdrinit.c:534-539 and
src/sdrnav.c:288-318) with a NumPy implementation vectorized over the 64
trellis states.  Polynomial convention matches ka9q (bit-reversed
G1=171o/G2=133o -> V27POLYA=0x4F, V27POLYB=0x6D; src/sdrinit.c:502), so a
data bit b entering state s gives symbols
``parity(((s<<1)|b) & POLY{A,B})`` with POLYA transmitted first.

Soft symbols are 0..255 with 0 = strong logical 0 (the reference maps nav
chip +1 -> 0, -1 -> 255; src/sdrnav.c:302-303).
"""
from __future__ import annotations

import numpy as np

from ..constants import V27POLYA, V27POLYB

_K = 7
_NSTATES = 1 << (_K - 1)   # 64


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


# precomputed branch outputs: for state s (6 bits) and input bit b,
# full register r = (s << 1) | b (7 bits, newest bit = LSB)
_S = np.arange(_NSTATES)
_R = ((_S[:, None] << 1) | np.array([0, 1])[None, :])   # (64, 2)
_OUT_A = _parity(_R & V27POLYA)                          # (64, 2)
_OUT_B = _parity(_R & V27POLYB)
_NEXT = _R & (_NSTATES - 1)                              # next state (64, 2)


def conv27_encode(bits01: np.ndarray, state: int = 0) -> np.ndarray:
    """Encode logical bits (0/1) -> soft symbols 0/255, POLYA symbol first."""
    bits01 = np.asarray(bits01, dtype=np.int64)
    out = np.empty(2 * len(bits01), dtype=np.uint8)
    r = state & (_NSTATES - 1)
    for i, b in enumerate(bits01):
        r = ((r << 1) | int(b)) & 0x7F
        out[2 * i] = 255 * _parity(np.int64(r & V27POLYA))
        out[2 * i + 1] = 255 * _parity(np.int64(r & V27POLYB))
    return out


def viterbi27_decode(symbols: np.ndarray, nbits: int,
                     start_state: int | None = None) -> np.ndarray:
    """Soft-decision Viterbi decode of ``2*(nbits+K-1)`` symbols (or fewer;
    traceback starts from the best end state) -> ``nbits`` logical bits.

    Mirrors the reference call pattern init / update over the block /
    chainback (src/sdrnav.c:304-308).  ``start_state=None`` initializes all
    states equally — correct for mid-stream decode where the encoder state
    at the buffer start is unknown (the reference forces state 0, which can
    corrupt the first bits of each SBAS buffer).
    """
    sym = np.asarray(symbols, dtype=np.float64)
    nsteps = len(sym) // 2
    # branch metric for (state, bit): distance of received pair from ideal
    sa = sym[0:2 * nsteps:2]     # (nsteps,)
    sb = sym[1:2 * nsteps:2]
    # ideal symbol values 0 or 255 per (state,bit)
    ia = 255.0 * _OUT_A          # (64, 2)
    ib = 255.0 * _OUT_B

    if start_state is None:
        metric = np.zeros(_NSTATES)
    else:
        metric = np.full(_NSTATES, 1e18)
        metric[start_state & (_NSTATES - 1)] = 0.0
    decisions = np.empty((nsteps, _NSTATES), dtype=np.uint8)

    prev_state = _NEXT            # (64,2): from state s with bit b -> next
    # build reverse map: for each next state n, the two (prev, bit) pairs
    rev_prev = np.empty((_NSTATES, 2), dtype=np.int64)
    rev_bit = np.empty((_NSTATES, 2), dtype=np.int64)
    fill = np.zeros(_NSTATES, dtype=np.int64)
    for s in range(_NSTATES):
        for b in range(2):
            n = prev_state[s, b]
            rev_prev[n, fill[n]] = s
            rev_bit[n, fill[n]] = b
            fill[n] += 1

    for t in range(nsteps):
        bm = np.abs(sa[t] - ia) + np.abs(sb[t] - ib)        # (64,2)
        cand = metric[rev_prev] + bm[rev_prev, rev_bit]      # (64,2)
        choice = np.argmin(cand, axis=1)                     # (64,)
        metric = cand[np.arange(_NSTATES), choice]
        decisions[t] = choice

    # traceback from best final state
    state = int(np.argmin(metric))
    bits = np.zeros(nsteps, dtype=np.uint8)
    for t in range(nsteps - 1, -1, -1):
        c = decisions[t, state]
        bits[t] = rev_bit[state, c]
        state = int(rev_prev[state, c])
    return bits[:nbits]
