"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip without a card.  This file imports no JAX, so it also runs on a
machine that has only PyTorch; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.constants import CodeType, DType
from gnsslib_tpu_torch.ops import ablation_taps as ab
from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.ops import gram_taps as gt
from gnsslib_tpu_torch.ops import window_taps as wt
from gnsslib_tpu_torch.ops.correlator import tap_offsets
from gnsslib_tpu_torch.tools import (profile_band, profile_gram,
                                     profile_kernel, profile_window)
from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                     state_from_numpy, state_to_numpy)

torch.set_num_threads(2)

F_SF, F_IF = 16.368e6, 4.092e6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _inputs(trk, B, iq, seed, dev):
    rng = np.random.default_rng(seed)
    nn = trk.n_nom
    nblock = 12 * nn + trk.next
    block = rng.integers(-128, 128, (nblock, 2) if iq else nblock
                         ).astype(np.float32)
    wstart = rng.integers(0, 10 * nn, B).astype(np.int32)
    n = rng.integers(nn - 2, nn + 3, B).astype(np.int32)
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, trk.next))
    act = rng.uniform(size=B) < 0.8
    host = (block, rc, wstart, n, rem, ftot, act)
    return host, [torch.from_numpy(a).to(dev) for a in host]


def _band_inputs(B, iq, seed, dev, smax, nn=16368, nwin=16376):
    """Band-correlator inputs at the main path's window length: a block of
    8-bit samples, +-1 replica rows of nwin + 2*smax bytes, windows inside
    the block with n around nn, 80% active."""
    rng = np.random.default_rng(seed)
    nblock = 12 * nn + nwin + 2 * smax
    block = rng.integers(-128, 128, (nblock, 2) if iq else nblock
                         ).astype(np.float32)
    wstart = rng.integers(0, 10 * nn, B).astype(np.int32)
    n = rng.integers(nn - 2, nn + 3, B).astype(np.int32)
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, nwin + 2 * smax))
    act = rng.uniform(size=B) < 0.8
    host = (block, rc, wstart, n, rem, ftot, act)
    return host, [torch.from_numpy(a).to(dev) for a in host]


@pytest.mark.cuda
@pytest.mark.parametrize("corrd", [1, 2, 3, 4])
@pytest.mark.parametrize("iq,corrn", [(False, 6), (True, 6), (False, 1),
                                      (False, 0), (True, 0), (False, 12),
                                      (True, 12)])
def test_band_taps_kernel_matches_plain(dev, iq, corrn, corrd):
    """The cluster kernel vs band_taps_plain on the card (both f32; only
    summation order and sincospif-vs-cos/sin rounding differ), at the main
    path's window length, at tap counts 1, 3, 13 and 25 and tap spacings
    1-4."""
    smax = corrn * corrd
    offsets = tap_offsets(corrn, corrd)
    host, args = _band_inputs(320, iq, 10 * corrn + corrd + iq, dev, smax)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) == (1, 0, 0)
    assert bool(okk) and bool(okp)
    tol = profile_band.tolerance(host, 16376)
    assert float((zk - zp).abs().max()) <= tol
    assert torch.all(zk[~args[6]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_kernel_short_and_ragged_windows(dev, iq):
    """n below one segment, n = 0 and n < 0 on active windows, n that is
    no multiple of S*J, n at a segment's edge, n beyond nwin, and windows
    that end at the block's last sample."""
    smax, nwin = 18, 16376
    host, args = _band_inputs(64, iq, 31 + iq, dev, smax)
    tile = bt.samples_per_thread() * 3              # kJ samples at d = 3
    seg = -(-(-(-nwin // bt.ctas_per_window())) // tile) * tile  # ceils
    n = np.asarray([1, 2, 99, 100, seg - 1, seg, seg + 1, 0, -5, nwin,
                    nwin + 40, 2 * seg + 17, 3 * seg - 1, 5000, 12345, 7],
                   np.int32)
    n = np.resize(n, 64)
    act = np.ones(64, bool)
    wstart = host[2].copy()
    nblock = host[0].shape[0]
    wstart[9] = nblock - nwin                      # ends at the last sample
    wstart[12] = nblock - (3 * seg - 1)
    args[2] = torch.from_numpy(wstart).to(dev)
    args[3] = torch.from_numpy(n).to(dev)
    args[6] = torch.from_numpy(act).to(dev)
    offsets = tap_offsets(6, 3)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert bt.COUNTS.kernel == 1 and bt.COUNTS.v1 == 0
    assert bool(okk) and bool(okp)
    tol = profile_band.tolerance((host[0], None, wstart, n), nwin)
    assert float((zk - zp).abs().max()) <= tol
    assert torch.all(zk[torch.from_numpy(n <= 0).to(dev)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, -1, 2), (0, -2, 2, -4, 5), (3,),
                                     (0, 3, -3)])
def test_band_taps_non_progression_goes_to_v1(dev, offsets):
    """Offsets that are not tap_offsets(corrn, d) launch the v1 kernel,
    counted in COUNTS.v1, and match the plain version."""
    smax = 6
    host, args = _band_inputs(64, False, 41, dev, smax)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, _ = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) == (0, 1, 0)
    assert bool(okk)
    tol = profile_band.tolerance(host, 16376)
    assert float((zk - zp).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("variant", ["v1", *profile_band.SAME[1:]])
def test_band_taps_variants_match_plain(dev, iq, variant):
    """The v1 kernel, and the cluster kernel's build steps 1-2 and other
    cluster sizes as tools/profile_band.py builds and times them, against
    the plain version at the main path's shapes (13 taps)."""
    smax = 18
    offsets = tap_offsets(6, 3)
    host, args = _band_inputs(320, iq, 51 + iq, dev, smax)
    zp, _ = bt.band_taps_plain(*args, offsets, smax)
    out = torch.empty_like(zp)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    if variant == "v1":
        bt.launch_v1(*args, offsets, smax, out, ok)
    else:      # one nvcc per variant, all in parallel on the first call
        lib = profile_band.build(profile_band.SAME)[variant]
        profile_band.launcher(lib, offsets, smax, out, ok)(args)
    torch.cuda.synchronize()
    assert int(ok[0]) == 1
    tol = profile_band.tolerance(host, 16376)
    assert float((out - zp).abs().max()) <= tol


# the multi-GNSS receiver's other channel groups at 16.368 Msps, 13 taps
# (CORRN/CORRD 6/3): (code type, channels, loop interval L, I/Q, IF)
GROUPS = {"SBAS": (CodeType.L1SBAS, 3, 2, False, 4.092e6),
          "G1-iq": (CodeType.G1, 14, 10, True, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("active", [1, 2, 3])
@pytest.mark.parametrize("group", list(GROUPS))
def test_band_taps_receiver_group_shapes(dev, group, active):
    """The cluster kernel against the plain version at the super-step
    shapes of the SBAS group (3 channels x L = 2: 6 windows per launch,
    12 CTAs) and of the GLONASS G1 group on I/Q samples (14 channels x
    L = 10, about 32 samples a chip), with ``active`` channels locked:
    the window length, replica row and tap band of the group's Tracker."""
    ctype, nch, L, iq, f_if = GROUPS[group]
    prns = list(range(-7, -7 + nch)) if ctype == CodeType.G1 else \
        [129, 133, 138]
    trk = Tracker(TrackConfig(6, 3, 6), prns, [ctype] * nch, F_SF, f_if,
                  DType.IQ if iq else DType.REAL, device=dev)
    B = nch * L
    host, args = _band_inputs(B, iq, 71 + active, dev, trk.smax,
                              nn=trk.n_nom, nwin=trk.nwin)
    act = np.repeat(np.arange(nch) < active, L)
    args[6] = torch.from_numpy(act).to(dev)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, trk.offsets, trk.smax)
    zp, okp = bt.band_taps_plain(*args, trk.offsets, trk.smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) == (1, 0, 0)
    assert bool(okk) and bool(okp)
    tol = profile_band.tolerance(host[:6] + (act,), trk.nwin)
    assert float((zk - zp).abs().max()) <= tol
    assert torch.all(zk[~args[6]] == 0)


@pytest.mark.cuda
def test_band_taps_13_tap_iq_does_not_spill(dev):
    """ptxas: the 13-tap I/Q instantiation of the cluster kernel (the G1
    group's) has no stack frame and no spill; the real one (GPS and SBAS)
    keeps its 64 registers without spill."""
    profile_band.build(["kernel"])
    text = profile_band._LIBS["kernel"][1]
    iq = profile_band.usage(text, True)
    real = profile_band.usage(text, False)
    assert iq["stack"] == iq["spill_stores"] == iq["spill_loads"] == 0, iq
    assert real["regs"] <= 64 and real["spill_stores"] == 0, real


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_bit_identical_and_graph_replay(dev, iq):
    """Two launches give bit-identical taps (no atomics, a fixed
    reduction order), and a launch captured in a CUDA graph and replayed
    gives the eager launch's bits."""
    smax = 18
    offsets = tap_offsets(6, 3)
    _, args = _band_inputs(320, iq, 61 + iq, dev, smax)
    z1, _ = bt.band_taps(*args, offsets, smax)
    z2, _ = bt.band_taps(*args, offsets, smax)
    torch.cuda.synchronize()
    assert torch.equal(z1.view(torch.int32), z2.view(torch.int32))
    out = torch.empty_like(z1)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        bt.launch(*args, offsets, smax, out, ok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bt.launch(*args, offsets, smax, out, ok)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), z1.view(torch.int32))
    assert int(ok[0]) == 1


@pytest.mark.cuda
def test_band_taps_kernel_flags_out_of_block(dev):
    trk = Tracker(TrackConfig(6, 3, 6), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.REAL, device="cpu")
    host, args = _inputs(trk, 16, False, 1, dev)
    offsets = trk.offsets
    args[6] = torch.ones_like(args[6])
    z, ok = bt.band_taps(*args, offsets, trk.smax)
    assert bool(ok)
    args[2] = args[2].clone()
    args[2][3] = host[0].shape[0] - 100            # runs off the end
    args[2][5] = -1                                 # starts before it
    z, ok = bt.band_taps(*args, offsets, trk.smax)
    assert not bool(ok)
    assert torch.all(z[3] == 0) and torch.all(z[5] == 0)
    args[6][3] = args[6][5] = False                 # inactive: no flag
    z, ok = bt.band_taps(*args, offsets, trk.smax)
    assert bool(ok)


@pytest.mark.cuda
def test_band_taps_kernel_rejects_bad_inputs(dev):
    trk = Tracker(TrackConfig(6, 3, 6), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.REAL, device="cpu")
    _, args = _inputs(trk, 8, False, 2, dev)
    offsets = trk.offsets
    mixed = list(args)
    mixed[4] = mixed[4].cpu()
    with pytest.raises(ValueError, match="rem is on cpu"):
        bt.band_taps(*mixed, offsets, trk.smax)
    with pytest.raises(ValueError, match="odd tap count"):
        bt.band_taps(*args, list(range(-13, 13)), 13)


def _window_inputs(trk, B, iq, seed, dev):
    """Fetched-window inputs at ``trk``'s shapes: 8-bit windows, +-1
    replica rows, valid lengths around n_nom."""
    rng = np.random.default_rng(seed)
    shape = (B, trk.nwin, 2) if iq else (B, trk.nwin)
    win = rng.integers(-128, 128, shape).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, trk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    n = rng.integers(trk.n_nom - 2, trk.n_nom + 3, B).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (win, rc, rem, ftot, n)]
    return win, n, t


def _tol(win, n, rel):
    """``rel`` of the largest window L1 norm over its valid samples (each
    tap sums n products bounded by |x_i|, |replica| <= 1)."""
    a = np.abs(win).reshape(win.shape[0], win.shape[1], -1).sum(-1)
    return rel * max(float(a[b, :k].sum()) for b, k in enumerate(n))


@pytest.mark.cuda
@pytest.mark.parametrize("fn,iq", [(f, iq) for f in ("correlate_windows",
                                                    "correlate_windows8",
                                                    "correlate_windows16")
                                   for iq in (False, True)])
def test_window_taps_kernels_match_plain(dev, fn, iq):
    """K5/K4 (f32) and K3 (bf16 windows, int8 rows) against
    window_taps_plain on the card at the main path's shapes.  f32: only
    summation order and sincosf rounding differ (1e-5 of the L1 norm, as
    K1); K3: one sincosf ulp can also flip a mixed sample's bf16 rounding,
    each flip moving a tap by <= 2^-8 |x_i|, so 1e-4."""
    trk = Tracker(TrackConfig(6, 3, 6), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.IQ if iq else DType.REAL, device="cpu")
    win, n, (w, rc, rem, ftot, nt) = _window_inputs(trk, 320, iq, 5 + iq,
                                                   dev)
    bf16 = fn == "correlate_windows16"
    if bf16:
        w = w.to(torch.bfloat16)
    else:
        rc = rc.to(torch.float32)
    counts = {"correlate_windows": wt.COUNTS5, "correlate_windows8":
              wt.COUNTS8, "correlate_windows16": wt.COUNTS16}[fn]
    counts.reset()
    zk = getattr(wt, fn)(w, rc, rem, ftot, nt, trk.offsets, trk.smax)
    zp = wt.window_taps_plain(w, rc, rem, ftot, nt, trk.offsets, trk.smax)
    torch.cuda.synchronize()
    assert counts.kernel == 1 and counts.plain == 0
    err = float((zk - zp).abs().max())
    assert err <= _tol(win, n, 1e-4 if bf16 else 1e-5), err


# --- K3 (bf16 windows, int8 rows) and K4/K5 (f32): the window kernels -- #
WINDOW_WRAPPERS = {"bf16": (wt.correlate_windows16, wt.COUNTS16),
                   "f32": (wt.correlate_windows8, wt.COUNTS8)}


def _win_inputs(kind, B, iq, seed, dev, smax, nwin=16376, nn=16368):
    """Fetched windows of ``kind`` ("bf16": K3, "f32": K4/K5) at the main
    path's window length: 8-bit samples, +-1 replica rows of nwin + 2*smax
    values, n around nn; returns (host windows, host n, tensors)."""
    rng = np.random.default_rng(seed)
    win = rng.integers(-128, 128, (B, nwin, 2) if iq else (B, nwin)
                       ).astype(np.float32)
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, nwin + 2 * smax))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    n = rng.integers(nn - 2, nn + 3, B).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (win, rc, rem, ftot, n)]
    if kind == "bf16":
        t[0] = t[0].to(torch.bfloat16)
    else:
        t[1] = t[1].to(torch.float32)
    return win, n, t


def _win_tol(kind, win, n):
    """Phase 3's tolerance over the windows' valid samples (1e-5 of the
    largest window L1 norm for f32, 1e-4 for K3's bf16 flips)."""
    nwin = win.shape[1]
    a = np.abs(win).reshape(win.shape[0], nwin, -1).sum(-1)
    l1 = max([1.0] + [float(a[b, :k].sum())
                      for b, k in enumerate(np.clip(n, 0, nwin))])
    return profile_window.tolerance(kind, l1)


def _win_run(kind, args, offsets, smax):
    """The wrapper's taps, the plain version's, and the counters' change."""
    fn, counts = WINDOW_WRAPPERS[kind]
    counts.reset()
    zk = fn(*args, offsets, smax)
    zp = wt.window_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    return zk, zp, (counts.kernel, counts.v1, counts.plain)


@pytest.mark.cuda
@pytest.mark.parametrize("corrd", [1, 2, 3, 4])
@pytest.mark.parametrize("iq,corrn", [(False, 6), (True, 6), (False, 1),
                                      (False, 0), (True, 0), (False, 12),
                                      (True, 12)])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_cluster_kernel_matches_plain(dev, kind, iq, corrn,
                                                  corrd):
    """The window cluster kernel (K3 and the f32 instantiation) vs
    window_taps_plain on the card at the main path's window length, at
    tap counts 1, 3, 13 and 25 and tap spacings 1-4: one cluster-kernel
    launch, no v1, no plain."""
    smax = corrn * corrd
    offsets = tap_offsets(corrn, corrd)
    win, n, args = _win_inputs(kind, 320, iq, 10 * corrn + corrd + iq, dev,
                               smax)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == (1, 0, 0)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_ragged_windows(dev, kind, iq):
    """n = 0 and n < 0, n below one segment, n that is no multiple of
    S*J, n at a segment's edge (either side), n = nwin and n beyond nwin."""
    smax, nwin, B = 18, 16376, 64
    win, _, args = _win_inputs(kind, B, iq, 71 + iq, dev, smax)
    tile = wt.samples_per_thread() * 3              # kJ samples at d = 3
    seg = -(-(-(-nwin // wt.ctas_per_window())) // tile) * tile  # ceils
    n = np.asarray([0, -5, 1, 2, 99, 100, 98, seg - 1, seg, seg + 1,
                    2 * seg + 17, 3 * seg - 1, nwin - 1, nwin, nwin + 40,
                    5000], np.int32)
    n = np.resize(n, B)
    args[4] = torch.from_numpy(n).to(dev)
    offsets = tap_offsets(6, 3)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == (1, 0, 0)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)
    assert torch.all(zk[torch.from_numpy(n <= 0).to(dev)] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,iq", [(1, False), (7, True), (321, False)])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_batch_sizes(dev, kind, B, iq):
    """Any number of windows (clusters of S CTAs each), one launch."""
    smax = 18
    win, n, args = _win_inputs(kind, B, iq, 81 + B, dev, smax)
    zk, zp, counts = _win_run(kind, args, tap_offsets(6, 3), smax)
    assert counts == (1, 0, 0) and zk.shape == (B, 26)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, -1, 2), (0, -2, 2, -4, 5), (3,),
                                     (0, 3, -3)])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_non_progression_goes_to_v1(dev, kind, offsets):
    """Offsets that are not tap_offsets(corrn, d) launch the v1 kernel,
    counted in v1 (not kernel), and match the plain version."""
    smax = 6
    win, n, args = _win_inputs(kind, 64, False, 91, dev, smax)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == (0, 1, 0)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_bit_identical_and_graph_replay(dev, kind, iq):
    """Two launches give bit-identical taps (no atomics, a fixed
    reduction order), and a launch captured in a CUDA graph and replayed
    gives the eager launch's bits."""
    smax = 18
    offsets = tap_offsets(6, 3)
    _, _, args = _win_inputs(kind, 320, iq, 101 + iq, dev, smax)
    fn, _ = WINDOW_WRAPPERS[kind]
    z1 = fn(*args, offsets, smax)
    z2 = fn(*args, offsets, smax)
    torch.cuda.synchronize()
    assert torch.equal(z1.view(torch.int32), z2.view(torch.int32))
    k = 1 if kind == "bf16" else 0
    out = torch.empty_like(z1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        wt.launch(k, *args, offsets, smax, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        wt.launch(k, *args, offsets, smax, out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), z1.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", profile_window.SAME)
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_profile_window_variants_match_plain(dev, kind, iq, variant):
    """The v1 kernel, and the window kernel's build steps, cluster sizes,
    chain lengths and conversions as tools/profile_window.py builds
    and times them, against the plain version at the main path's shapes
    (13 taps)."""
    trk, l1, _, args = profile_window.inputs(dev, kind, iq)
    zp = wt.window_taps_plain(*args, trk.offsets, trk.smax)
    out = torch.empty_like(zp)
    if variant == "v1":
        wt.launch_v1(profile_window.KINDS[kind], *args, trk.offsets,
                     trk.smax, out)
    else:      # one nvcc per variant, all in parallel on the first call
        lib = profile_window.build(profile_window.VARIANTS)[variant]
        profile_window.launcher(lib, kind, trk.offsets, trk.smax, out)(args)
    torch.cuda.synchronize()
    assert float((out - zp).abs().max()) <= profile_window.tolerance(kind,
                                                                     l1)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_gram_taps_kernel_matches_plain(dev, iq):
    """K2 against gram_taps_plain on the card at the main path's shapes
    ((320, 128, 128) bf16 rows); bf16 flips bound the error as for K3."""
    trk = Tracker(TrackConfig(6, 3, 6), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.IQ if iq else DType.REAL, device=dev)
    fast = FastTracker(trk)
    win, n, (w, rc, rem, ftot, nt) = _window_inputs(trk, 320, iq, 9 + iq,
                                                   dev)
    block2 = fast._block_rows(w.reshape((-1,) + w.shape[2:]))
    starts = torch.arange(320, device=dev, dtype=torch.int32) * trk.nwin
    rows = fast._fetch_windows(block2, starts, rowform=True, nvalid=nt)
    wi, wq = rows if iq else (rows, None)
    gt.COUNTS.reset()
    zk = gt.gram_taps(wi, wq, rc, rem, ftot, trk.offsets, trk.smax)
    zp = gt.gram_taps_plain(wi, wq, rc, rem, ftot, trk.offsets, trk.smax)
    torch.cuda.synchronize()
    assert gt.COUNTS.kernel == 1 and gt.COUNTS.plain == 0
    assert gt.COUNTS.v1 == 0
    assert float((zk - zp).abs().max()) <= _tol(win, n, 1e-4)


def _gram_inputs(B, K, iq, seed, dev, smax, nvalid=None, short=0):
    """K2 inputs: (B, K, 128) bf16 rows of 8-bit values masked to valid
    lengths ``nvalid`` (default: within 300 of K*128), +-1 replica rows
    of K*128 + 2*smax - ``short`` bytes, rates around the main path's.
    Returns (the tolerance, 1e-4 of the largest window L1 norm, and
    [win_i, win_q or None, rc, rem, ftot] on ``dev``)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(K * 128 - 300, K * 128 + 1, B) if nvalid is None \
        else np.asarray(nvalid)
    keep = np.arange(K * 128).reshape(K, 128)[None] < n[:, None, None]
    rows = [(rng.integers(-128, 128, (B, K, 128)) * keep).astype(np.float32)
            for _ in range(2 if iq else 1)]
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, K * 128 + 2 * smax
                                                   - short))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = (0.25 + rng.uniform(-4e-4, 4e-4, B)).astype(np.float32)
    l1 = max([1.0] + [float(sum(np.abs(r[b]).sum() for r in rows))
                      for b in range(B)])
    t = [torch.from_numpy(r).to(torch.bfloat16).to(dev) for r in rows]
    return 1e-4 * l1, [t[0], t[1] if iq else None] + [
        torch.from_numpy(a).to(dev) for a in (rc, rem, ftot)]


def _gram_run(args, offsets, smax):
    """The wrapper's taps, the plain version's, and the counters."""
    gt.COUNTS.reset()
    zk = gt.gram_taps(*args, offsets, smax)
    zp = gt.gram_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    return zk, zp, (gt.COUNTS.kernel, gt.COUNTS.v1, gt.COUNTS.plain)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("B,K,corrn,corrd,short", [
    (320, 128, 6, 3, 8),        # the main path's geometry, 13 taps
    (5, 128, 12, 3, 0),         # 25 taps, smax = 36: 11 n-tiles
    (7, 33, 6, 3, 36),          # K not a multiple of 16; B = 7
    (7, 33, 1, 2, 0),
    (3, 1, 2, 4, 3),            # one row: rank 1 of each cluster idle
    (4, 200, 6, 1, 5),
])
def test_gram_taps_banded_kernel_matches_plain(dev, iq, B, K, corrn, corrd,
                                               short):
    """K2's banded-Gram kernel (COUNTS.kernel, no v1) against the plain
    version for tap_offsets(corrn, d) geometries up to the 25-tap smax = 36
    one, K = 33 rows and B = 7 windows; replica rows shorter than the rows'
    extent count 0 past their end."""
    offsets = tuple(int(o) for o in tap_offsets(corrn, corrd))
    smax = corrn * corrd
    tol, args = _gram_inputs(B, K, iq, 300 + K + corrn + iq, dev, smax,
                             short=short)
    zk, zp, counts = _gram_run(args, offsets, smax)
    assert counts == (1, 0, 0)
    assert float((zk - zp).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("offsets,smax", [((0, 5, -7), 18), ((2,), 3),
                                          ((0, -1, 2), 40)])
def test_gram_taps_any_offsets_and_wide_band(dev, offsets, smax):
    """The banded-Gram kernel takes any offsets within its band; a band
    wider than its largest instantiation (smax 40 > 36) launches the v1
    kernel (COUNTS.v1); both match the plain version."""
    tol, args = _gram_inputs(6, 128, False, 41 + smax, dev, smax)
    zk, zp, counts = _gram_run(args, offsets, smax)
    assert counts == ((0, 1, 0) if smax > gt.MAX_SMAX else (1, 0, 0))
    assert float((zk - zp).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_gram_taps_zero_valid_windows(dev, iq):
    """Windows with no valid samples (rows of zeros) give zeros beside
    windows with samples, and K = 0 rows give zeros for every window."""
    smax = 18
    offsets = tap_offsets(6, 3)
    tol, args = _gram_inputs(6, 128, iq, 7 + iq, dev, smax,
                             nvalid=[0, 16376, 0, 100, 0, 16384])
    zk, zp, counts = _gram_run(args, offsets, smax)
    assert counts == (1, 0, 0)
    assert float((zk - zp).abs().max()) <= tol
    assert torch.all(zk[0::2] == 0)
    empty = [None if a is None else a[:, :0].contiguous() if a.dim() == 3
             else a for a in args]
    z0 = gt.gram_taps(*empty, offsets, smax)
    torch.cuda.synchronize()
    assert z0.shape == zk.shape and torch.all(z0 == 0)


@pytest.mark.cuda
def test_gram_taps_unaligned_rows(dev):
    """Rows whose storage does not start on 16 bytes (a view two values
    in) are staged by plain copies and give the aligned rows' bits."""
    smax = 18
    offsets = tap_offsets(6, 3)
    tol, args = _gram_inputs(4, 64, True, 12, dev, smax)
    shifted = []
    for a in args[:2]:
        flat = torch.zeros(a.numel() + 2, dtype=a.dtype, device=dev)
        flat[2:] = a.reshape(-1)
        shifted.append(flat[2:].view(a.shape))
    assert shifted[0].data_ptr() % 16 != 0
    z = gt.gram_taps(*args, offsets, smax)
    zs = gt.gram_taps(*shifted, *args[2:], offsets, smax)
    torch.cuda.synchronize()
    assert torch.equal(z.view(torch.int32), zs.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_gram_taps_bit_identical_and_graph_replay(dev, iq):
    """Two launches give bit-identical taps (no atomics, a fixed
    reduction order), and a launch captured in a CUDA graph and replayed
    gives the eager launch's bits."""
    smax = 18
    offsets = tap_offsets(6, 3)
    _, args = _gram_inputs(320, 128, iq, 111 + iq, dev, smax)
    z1 = gt.gram_taps(*args, offsets, smax)
    z2 = gt.gram_taps(*args, offsets, smax)
    torch.cuda.synchronize()
    assert torch.equal(z1.view(torch.int32), z2.view(torch.int32))
    out = torch.empty_like(z1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        gt.launch(*args, offsets, smax, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gt.launch(*args, offsets, smax, out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), z1.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", profile_gram.SAME)
@pytest.mark.parametrize("iq", [False, True])
def test_profile_gram_variants_match_plain(dev, iq, variant):
    """The v1 kernel, and the banded-Gram kernel's build steps, cluster
    sizes and register cap as tools/profile_gram.py builds and times them,
    against the plain version at the main path's shapes (13 taps)."""
    trk, l1, _, args = profile_gram.inputs(dev, iq)
    zp = gt.gram_taps_plain(*args, trk.offsets, trk.smax)
    out = torch.empty_like(zp)
    if variant == "v1":
        gt.launch_v1(*args, trk.offsets, trk.smax, out)
    else:      # one nvcc per variant, all in parallel on the first call
        lib = profile_gram.build(profile_gram.VARIANTS)[variant]
        profile_gram.launcher(lib, trk.offsets, trk.smax, out)(args)
    torch.cuda.synchronize()
    assert float((out - zp).abs().max()) <= profile_gram.tolerance(l1)


@pytest.mark.cuda
def test_fetch_backends_reject_bad_inputs(dev):
    trk = Tracker(TrackConfig(6, 3, 6), [1], [CodeType.L1CA], F_SF, F_IF,
                  DType.REAL, device="cpu")
    _, _, (w, rc, rem, ftot, nt) = _window_inputs(trk, 8, False, 2, dev)
    with pytest.raises(TypeError, match="rc must be torch.float32"):
        wt.correlate_windows(w, rc, rem, ftot, nt, trk.offsets, trk.smax)
    with pytest.raises(ValueError, match="rem is on cpu"):
        wt.correlate_windows16(w.to(torch.bfloat16), rc, rem.cpu(), ftot,
                               nt, trk.offsets, trk.smax)
    with pytest.raises(ValueError, match="odd tap count"):
        gt.gram_taps(torch.zeros((8, 2, 128), dtype=torch.bfloat16,
                                 device=dev), None, rc, rem, ftot,
                     list(range(-13, 13)), 13)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_ablation_taps_kernel_matches_plain(dev, variant):
    """K6's four variants against their plain versions on the card at the
    profiler's shapes (B = 320, nwin = 16493, W = 18229, 13 taps), each
    one cluster-kernel launch: f32, only summation order and the carrier's
    rounding differ, 1e-5 of each window's L1 norm."""
    args = profile_kernel.inputs(dev)
    ab.COUNTS[variant].reset()
    zk = ab.ablation_taps(*args, profile_kernel.OFFSETS,
                          profile_kernel.SMAX, variant)
    zp = ab.PLAIN[variant](*args, profile_kernel.OFFSETS,
                           profile_kernel.SMAX)
    torch.cuda.synchronize()
    assert ab.COUNTS[variant].values() == {"kernel": 1, "v1": 0, "plain": 0}
    l1 = args[0].abs().sum(dim=1)
    err = (zk - zp).abs().max(dim=1).values
    assert bool(torch.all(err <= 1e-5 * l1)), float(err.max())


@pytest.mark.cuda
def test_ablation_taps_in_cuda_graph(dev):
    """The scan test's chained launches captured in one CUDA graph give
    the eager chain's result; capture counts its launches once."""
    args = profile_kernel.inputs(dev, B=64, nwin=4000)
    c0 = torch.zeros((), device=dev)
    eager = profile_kernel._scan_body(args, "full", 5, c0)
    ab.COUNTS["full"].reset()
    eager_ms, graph_ms = profile_kernel.scan(args, "full", dev, iters=5,
                                             reps=2)
    # eager (a warm-up and 2 timed chains), 2 side-stream warm-ups, capture
    assert ab.COUNTS["full"].kernel == 5 * 3 + 2 + 5
    assert eager_ms > 0 and graph_ms > 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c_out = profile_kernel._scan_body(args, "full", 5, c0)
    graph.replay()
    torch.cuda.synchronize()
    assert float(c_out) == pytest.approx(float(eager), rel=1e-6)


def _ab_run(variant, args, offsets, smax):
    """K6's wrapper taps, the plain version's, and the counters' change."""
    counts = ab.COUNTS[variant]
    counts.reset()
    zk = ab.ablation_taps(*args, offsets, smax, variant)
    zp = ab.PLAIN[variant](*args, offsets, smax)
    torch.cuda.synchronize()
    return zk, zp, (counts.kernel, counts.v1, counts.plain)


def _ab_ok(zk, zp, win):
    """Within 1e-5 of each window's L1 norm (phase 3's K6 tolerance)."""
    err = (zk - zp).abs().max(dim=1).values
    return bool(torch.all(err <= 1e-5 * win.abs().sum(dim=1)))


@pytest.mark.cuda
def test_ablation_taps_full_is_k4_bit_for_bit(dev):
    """K6's full variant is K4's f32 cluster instantiation: at K6's
    ascending offsets its taps equal correlate_windows8's at
    tap_offsets(6, 3) (the same lags) bit for bit, columns permuted, with
    K4's int bound ceil(n) (the same samples, i < n)."""
    args = profile_kernel.inputs(dev)
    win, rc, rem, ftot, n = args
    offs, smax = profile_kernel.OFFSETS, profile_kernel.SMAX
    k4 = tuple(int(o) for o in tap_offsets(6, 3))
    z4 = wt.correlate_windows8(win, rc, rem, ftot,
                               torch.ceil(n).to(torch.int32), k4, smax)
    z6 = ab.ablation_taps(*args, offs, smax, "full")
    torch.cuda.synchronize()
    cols = [2 * k4.index(o) + c for o in offs for c in (0, 1)]
    assert torch.equal(z6.view(torch.int32),
                       z4[:, cols].contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_ablation_taps_bit_identical_and_graph_replay(dev, variant):
    """Two launches of each variant give bit-identical taps (a fixed
    reduction order, no atomics), and a launch captured in a CUDA graph
    and replayed gives the eager launch's bits."""
    args = profile_kernel.inputs(dev)
    offs, smax = profile_kernel.OFFSETS, profile_kernel.SMAX
    z1 = ab.ablation_taps(*args, offs, smax, variant)
    z2 = ab.ablation_taps(*args, offs, smax, variant)
    torch.cuda.synchronize()
    assert torch.equal(z1.view(torch.int32), z2.view(torch.int32))
    out = torch.empty_like(z1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        ab.launch(variant, *args, offs, smax, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        assert ab.launch(variant, *args, offs, smax, out) == "kernel"
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), z1.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, -1, 2), (0, -2, 2, -4, 5),
                                     (0, 0, 3)])
@pytest.mark.parametrize("variant", ["full", "nosin", "onetap"])
def test_ablation_taps_non_progression_goes_to_v1(dev, variant, offsets):
    """Lags that sorted form no progression launch the v1 kernel,
    counted in v1 (not kernel), and match the plain version."""
    args = profile_kernel.inputs(dev, B=16, nwin=3000)
    zk, zp, counts = _ab_run(variant, args, offsets, 6)
    assert counts == (0, 1, 0)
    assert _ab_ok(zk, zp, args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("offsets,smax", [
    ((0,), 4), ((-3, 0, 3), 3), (tuple(range(-36, 37, 3)), 36),
    (tuple(int(o) for o in tap_offsets(6, 2)), 12)])
@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_ablation_taps_odd_shapes(dev, variant, offsets, smax):
    """B = 7 windows of 2999 samples (no multiple of any tile), valid
    bounds 0, negative, fractional, at a segment's edges and beyond nwin,
    at 1, 3, 13 (tap_offsets order) and 25 taps: one cluster-kernel launch
    each, within 1e-5 of each window's L1 norm, zero taps where n <= 0."""
    B, nwin = 7, 2999
    args = list(profile_kernel.inputs(dev, B=B, nwin=nwin, smax=smax))
    # rows as long as the variant's lags reach (aligned's 128 t, 25 taps)
    W = nwin + max(ab.lags(variant, offsets, smax)) + 3
    rng = np.random.default_rng(len(offsets))
    args[1] = torch.from_numpy(rng.choice([-1.0, 1.0], (B, W)).astype(
        np.float32)).to(dev)
    d = ab.plan(variant, offsets, smax)[1]
    tile = ab.samples_per_thread() * d
    seg = -(-(-(-nwin // ab.ctas_per_window())) // tile) * tile
    n = torch.tensor([0.0, -2.5, 0.3, 1234.5, seg - 0.5, seg + 0.25,
                      nwin + 7.0], dtype=torch.float32, device=dev)
    args[4] = n
    zk, zp, counts = _ab_run(variant, args, offsets, smax)
    assert counts == (1, 0, 0) and zk.shape == (B, 2 * len(offsets))
    assert _ab_ok(zk, zp, args[0])
    assert torch.all(zk[:2] == 0)


@pytest.mark.cuda
def test_ablation_taps_chain_constants(dev):
    """K6's cluster kernel is the window cluster kernel: the same chain
    length and CTAs per window (the CPU decomposition test models 33 and
    2)."""
    assert ab.samples_per_thread() == wt.samples_per_thread() == 33
    assert ab.ctas_per_window() == wt.ctas_per_window() == 2


# --- every launch opts in the shared memory it uses (csrc/launch.cuh) ---- #
# Static shared memory counts against the 48 KB default, so a launch whose
# dynamic bytes fit in 48 KB (49152) but whose dynamic plus static bytes do
# not is refused unless its kernel is opted in.  Each case below takes a
# shape in that gap for one launch site; the static bytes are the kernel's
# __shared__ arrays at the case's tap count.  A v1 kernel's (part[kWarps]
# [2 * taps] floats, 192 bytes at 3 taps, 832 at 13) are above zero, so
# a v1 launch with exactly 48 KB of dynamic bytes is in its gap.
GAP = 48 * 1024
STATIC_CLUSTER_13 = 8 * 32 * 4 + 2 * 26 * 4   # part + gather, 13 taps


def _staged(count):                   # csrc/stage_async.cuh's staged_bytes
    return (count + 30) // 16 * 16


def _cluster_bytes(nwin, d, ntaps, wbytes, rbytes):
    """The window cluster kernel's dynamic bytes (launch_cluster): the
    segment's replica values and window samples, staged at any head."""
    tile = 33 * d
    seg = -(-(-(-nwin // 2)) // tile) * tile
    return _staged((seg + (ntaps - 1) * d) * rbytes) + _staged(seg * wbytes)


def _gap_nwin(nbytes, static):
    """The window length whose dynamic bytes ``nbytes(nwin)`` come closest
    below 48 KB; asserts that they and ``static`` exceed it together."""
    nwin = max((w for w in range(1000, 100000, 7) if nbytes(w) <= GAP),
               key=nbytes)
    assert nbytes(nwin) <= GAP < nbytes(nwin) + static
    return nwin


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "v1"])
def test_ablation_taps_opt_in_gap(dev, route):
    """K6 at shapes in its gap: the cluster kernel at 13 taps (f32 window
    and replica segments), and the v1 kernel (an f32 row of W values) for
    lags with no progression."""
    if route == "kernel":
        offsets, smax = profile_kernel.OFFSETS, profile_kernel.SMAX
        nwin = _gap_nwin(lambda w: _cluster_bytes(w, 3, 13, 4, 4),
                         STATIC_CLUSTER_13)
        args = profile_kernel.inputs(dev, B=8, nwin=nwin)
    else:
        offsets, smax = (0, -1, 2), 2               # W * 4 = 48 KB exactly
        args = list(profile_kernel.inputs(dev, B=8, nwin=12000, smax=smax))
        args[1] = args[1][:, :GAP // 4].contiguous()
    zk, zp, counts = _ab_run("full", args, offsets, smax)
    assert counts == ((1, 0, 0) if route == "kernel" else (0, 1, 0))
    assert _ab_ok(zk, zp, args[0])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "v1"])
def test_band_taps_opt_in_gap(dev, route):
    """K1 at shapes in its gap: the cluster kernel (the main path's
    launch site) at 13 taps with int8 replica segments near 48 KB, and
    the v1 kernel with a 49152-byte row."""
    if route == "kernel":
        offsets, smax = tap_offsets(6, 3), 18
        nwin = _gap_nwin(lambda w: _staged(-(-(-(-w // 2)) // 99) * 99
                                           + 36), STATIC_CLUSTER_13)
    else:
        offsets, smax = (0, -1, 2), 2
        nwin = GAP - 2 * smax                       # next = 48 KB
    host, args = _band_inputs(8, False, 5, dev, smax, nn=nwin - 8,
                              nwin=nwin)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1) == ((1, 0) if route == "kernel"
                                                else (0, 1))
    assert bool(okk) and bool(okp)
    assert float((zk - zp).abs().max()) <= profile_band.tolerance(host, nwin)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "v1"])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_opt_in_gap(dev, kind, route):
    """K3-K5 at shapes in their gap: the cluster kernel at 13 taps, and
    the v1 kernel with a 48 KB row (12288 f32 or 49152 int8 values)."""
    wbytes, rbytes = (2, 1) if kind == "bf16" else (4, 4)
    if route == "kernel":
        offsets, smax = tap_offsets(6, 3), 18
        nwin = _gap_nwin(lambda w: _cluster_bytes(w, 3, 13, wbytes, rbytes),
                         STATIC_CLUSTER_13)
    else:
        offsets, smax = (0, -1, 2), 2
        nwin = GAP // rbytes - 2 * smax
    win, n, args = _win_inputs(kind, 8, False, 7, dev, smax, nwin=nwin,
                               nn=nwin - 8)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == ((1, 0, 0) if route == "kernel" else (0, 1, 0))
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)


@pytest.mark.cuda
def test_gram_taps_v1_opt_in_gap(dev):
    """K2's v1 kernel (361 rows: more than the banded Gram takes) at
    361 * (8 + 128) + 2 * 28 = 49152 dynamic bytes."""
    K, smax = 361, 28
    assert K * (8 + 128) + 2 * smax == GAP
    tol, args = _gram_inputs(4, K, False, 9, dev, smax)
    zk, zp, counts = _gram_run(args, tap_offsets(6, 4), smax)
    assert counts == (0, 1, 0)
    assert float((zk - zp).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("corr", ["band", "pallas", "fused"])
def test_fast_tracker_card_matches_cpu(dev, corr):
    """FastTracker through the kernel on the card against the plain
    correlator on the CPU, from one state (test_fast.py's tolerances)."""
    prns = [3, 9, 14]
    f_sf, f_if = 4.092e6, 1.023e6
    ch = [sim.SimChannel(prn=3, doppler=900.0,
                         code_phase=-800 * 1.023e6 / f_sf),
          sim.SimChannel(prn=9, doppler=-1500.0,
                         code_phase=-2100 * 1.023e6 / f_sf)]
    noise = sim.noise_std_for_cn0(1.0, 45.0, f_sf, DType.REAL)
    x = np.asarray(sim.synthesize(ch, f_sf, f_if, DType.REAL,
                                  int(1.0 * f_sf), noise_std=noise, seed=4),
                   np.float32)
    cpu = torch.device("cpu")
    trks = {d: Tracker(TrackConfig(4, 2, 2), prns, [CodeType.L1CA] * 3,
                       f_sf, f_if, DType.REAL, device=d) for d in (dev, cpu)}
    st = trks[cpu].start_channels(trks[cpu].init_state(), [0, 1],
                                  [800, 2100], [-900.0, 1500.0])
    st, _ = trks[cpu].run_block(st, torch.from_numpy(x), 300)
    for c in range(2):
        st = trks[cpu].set_bit_sync(st, c, 0)
    snap = state_to_numpy(st)
    out = {}
    for d in (dev, cpu):
        f = FastTracker(trks[d])
        f.corr = corr
        _, out[d] = f.run_block(state_from_numpy(snap, d),
                                torch.from_numpy(x).to(d), 600)
    a, b = out[cpu], out[dev]
    np.testing.assert_array_equal(a.loc[:, :2], b.loc[:, :2])
    scale = np.max(np.abs(a.ip[:, :2]))
    for u, v in ((a.ip, b.ip), (a.qp, b.qp)):
        d = np.abs(u[:, :2] - v[:, :2])
        assert int(np.sum(d > 5e-3 * scale)) <= 3
        assert np.median(d) < 1e-3 * scale
    np.testing.assert_allclose(a.dcarr[:, :2], b.dcarr[:, :2], atol=0.5)


# --- block programs: CUDA graphs of the trackers' blocks --------------- #
GRAPH_SIGNAL = {3: (800, 900.0), 9: (2100, -1500.0)}   # delay, Doppler
# the counter each engine's captured program launches (xla and pull-in
# launch no kernel of the port)
GRAPH_COUNTS = {"band": ("band_taps", bt.COUNTS), "pallas":
                ("correlate_windows16", wt.COUNTS16),
                "fused": ("gram_taps", gt.COUNTS)}


def _graph_scene(dev):
    """test_torch_program.py's scene on the card: two satellites at 4.092
    Msps, three channels, the visible two pulled in (eager) and synced."""
    f_sf, f_if = 4.092e6, 1.023e6
    ch = [sim.SimChannel(prn=p, doppler=dop, code_phase=-d * 1.023e6 / f_sf)
          for p, (d, dop) in GRAPH_SIGNAL.items()]
    noise = sim.noise_std_for_cn0(1.0, 45.0, f_sf, DType.REAL)
    x = np.asarray(sim.synthesize(ch, f_sf, f_if, DType.REAL,
                                  int(0.6 * f_sf), noise_std=noise, seed=4),
                   np.float32)
    trk = Tracker(TrackConfig(4, 2, 2), [3, 9, 14], [CodeType.L1CA] * 3,
                  f_sf, f_if, DType.REAL, device=dev)
    st = trk.start_channels(trk.init_state(), [0, 1],
                            [d for d, _ in GRAPH_SIGNAL.values()],
                            [-dop for _, dop in GRAPH_SIGNAL.values()])
    block = torch.from_numpy(x).to(dev)
    st, _ = trk.run_block_eager(st, block, 100)
    for c in range(2):
        st = trk.set_bit_sync(st, c, 0)
    return trk, st, block


def _graph_engine(trk, name):
    if name == "pullin":
        return trk
    fast = FastTracker(trk)
    fast.corr = name
    return fast


def _bits_equal(a, b) -> bool:
    a, b = a.cpu(), b.cpu()      # a replayed block's telemetry is on the host
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _same_state(a, b) -> bool:
    return all(_bits_equal(getattr(a, k), getattr(b, k))
               for k in a.__dataclass_fields__)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pullin", "band", "pallas", "fused",
                                  "xla"])
def test_block_program_replay_matches_eager(dev, name):
    """A block replayed from the captured graph gives the eager loop's
    state and telemetry bit for bit; a replay adds the captured launches
    to the wrapper's counter (COUNTS = replays x captured launches, the
    capture itself counted as none); blocks reuse the one capture."""
    trk, st, block = _graph_scene(dev)
    eng = _graph_engine(trk, name)
    nsteps = 40
    prog = eng.program(nsteps, block.shape)
    assert prog.graph is not None and prog.capture_s > 0
    label, counts = GRAPH_COUNTS.get(name, (None, None))
    if counts is None:
        assert prog.launches == {}
    else:
        assert prog.launches == {label: {"kernel": nsteps // eng.L}}
        counts.reset()
    n0 = len(eng.programs)
    for _ in range(3):
        got = eng.run_block_start(st, block, nsteps)
    torch.cuda.synchronize()
    ref = eng.run_block_eager(st, block, nsteps)
    torch.cuda.synchronize()
    assert _same_state(got[0], ref[0])
    assert _bits_equal(got[1][0], ref[1][0])
    assert _bits_equal(got[1][1], ref[1][1])
    assert len(eng.programs) == n0 and prog.replays == 3
    if counts is not None:
        # three replays, then the eager reference's own launches
        assert counts.kernel == 4 * prog.launches[label]["kernel"]
        assert counts.plain == 0


def _host_edits(trk, st, k: int, adv: int):
    """The receiver's host edits after the ``k``-th block: the window
    rebased, and a channel started, bit-synced or restarted."""
    st = trk.rebase(st, adv)
    if k == 0:
        st = trk.start_channels(st, [2], [500], [250.0])
    if k == 1:
        st = trk.set_bit_sync(st, 2, 0)
    if k == 2:
        st = trk.start_channels(st, [0], [900], [-900.0])
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pullin", "band"])
def test_block_program_pipelined_edits_match_eager(dev, name):
    """Four blocks queued two deep through the graph, with a channel
    started, bit-synced and restarted and the window rebased between
    them, give the eager loop's blocks run one at a time, bit for bit."""
    trk, st, block = _graph_scene(dev)
    eng = _graph_engine(trk, name)
    nsteps, adv = 20, 20 * trk.n_nom
    base = 100 * trk.n_nom
    st0 = trk.rebase(st, base)

    def run(start):
        st, handles = st0, []
        for k in range(4):
            st, h = start(st, block[base + k * adv:base + (k + 6) * adv],
                          nsteps)
            handles.append(h)
            st = _host_edits(trk, st, k, adv)
        return st, handles

    st_g, replayed = run(eng.run_block_start)
    st_e, eager = run(eng.run_block_eager)
    torch.cuda.synchronize()
    assert _same_state(st_g, st_e)
    for hg, he in zip(replayed, eager):
        assert _bits_equal(hg[0], he[0]) and _bits_equal(hg[1], he[1])
    progs = list(eng.programs.values())
    assert len(progs) == 1 and progs[0].replays == 4


# ~25-50 ms of a spinning kernel at the H100's clocks: far longer than a
# block of the scene takes
SPIN_CYCLES = 50_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pullin", "band"])
def test_pipelined_collect_waits_for_its_own_block(dev, name):
    """Four blocks queued two deep with the host edits between them, and
    a spinning kernel queued before each, so that a block's telemetry
    lands on the host long after its start returns and the host's
    uploads are queued behind work still running: every collect waits
    for its own block (its end event) and gives the eager loop's
    telemetry, end state and TrackOutputs run one block at a time, bit
    for bit; the collects made while the card still spun count as not
    ready."""
    from gnsslib_tpu_torch.spans import SpanTable
    trk, st, block = _graph_scene(dev)
    eng = _graph_engine(trk, name)
    nsteps, adv = 20, 20 * trk.n_nom
    base = 100 * trk.n_nom
    st0 = trk.rebase(st, base)
    blocks = [block[base + k * adv:base + (k + 6) * adv] for k in range(4)]
    eng.program(nsteps, blocks[0].shape)          # captured before
    st_e, ref = st0, []
    for k, blk in enumerate(blocks):
        st_e, h = eng.run_block_eager(st_e, blk, nsteps)
        ref.append((h, eng.run_block_collect(h)))
        st_e = _host_edits(trk, st_e, k, adv)
    eng.spans = SpanTable()
    try:
        st_g, pend, got = st0, [], []
        for k, blk in enumerate(blocks):
            torch.cuda._sleep(SPIN_CYCLES)
            st_g, h = eng.run_block_start(st_g, blk, nsteps)
            pend.append(h)
            st_g = _host_edits(trk, st_g, k, adv)
            if len(pend) > 2:
                h = pend.pop(0)
                got.append((h, eng.run_block_collect(h)))
        got += [(h, eng.run_block_collect(h)) for h in pend]
        rows = eng.spans.table()["stages"]["other"]
    finally:
        del eng.spans                      # back to the class's NULL
    assert _same_state(st_g, st_e)
    for (hg, og), (he, oe) in zip(got, ref):
        assert _bits_equal(hg[0], he[0]) and _bits_equal(hg[1], he[1])
        for f in og.__dataclass_fields__:
            a, b = getattr(og, f), getattr(oe, f)
            assert a.dtype == b.dtype and np.array_equal(
                np.ascontiguousarray(a).view(np.uint8),
                np.ascontiguousarray(b).view(np.uint8)), f
    assert rows["track.wait"]["n"] == 4
    assert rows.get("track.ready", {"n": 0})["n"] < 4


# --- wide geometries: more taps than the sources instantiate (T > 25) -- #
WIDE = [(16, 2), (20, 2), (32, 1)]          # 33, 41 and 65 taps


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("corrn,corrd", WIDE)
def test_band_taps_wide_kernel_matches_plain(dev, corrn, corrd, iq):
    """K1 at 33, 41 and 65 taps: one launch of the wide cluster kernel
    (COUNTS.kernel), within phase 3's tolerance of the plain version,
    inactive windows zero, two launches bit-identical, and a launch
    replayed from a CUDA graph equal to the eager one."""
    smax = corrn * corrd
    offsets = tap_offsets(corrn, corrd)
    host, args = _band_inputs(320, iq, 500 + corrn + iq, dev, smax)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    z2, _ = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) == (2, 0, 0)
    assert bool(okk) and bool(okp)
    assert float((zk - zp).abs().max()) <= profile_band.tolerance(host,
                                                                  16376)
    assert torch.all(zk[~args[6]] == 0)
    assert torch.equal(zk.view(torch.int32), z2.view(torch.int32))
    out = torch.empty_like(zk)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        bt.launch(*args, offsets, smax, out, ok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bt.launch(*args, offsets, smax, out, ok)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), zk.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_wide_kernel_ragged_and_out_of_block(dev, iq):
    """K1 at 33 taps on ragged valid lengths (n <= 0, below a segment,
    past nwin, a window ending at the block's last sample), then with an
    active window off the block: zeros there and the flag cleared."""
    smax, nwin = 32, 16376
    offsets = tap_offsets(16, 2)
    host, args = _band_inputs(64, iq, 531 + iq, dev, smax)
    n = np.resize(np.asarray([1, 2, 65, 66, 8249, 8250, 8251, 0, -5, nwin,
                              nwin + 40, 12345, 7], np.int32), 64)
    wstart = host[2].copy()
    wstart[9] = host[0].shape[0] - nwin
    args[2] = torch.from_numpy(wstart).to(dev)
    args[3] = torch.from_numpy(n).to(dev)
    args[6] = torch.ones(64, dtype=torch.bool, device=dev)
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert bool(okk) and bool(okp)
    tol = profile_band.tolerance((host[0], None, wstart, n), nwin)
    assert float((zk - zp).abs().max()) <= tol
    assert torch.all(zk[torch.from_numpy(n <= 0).to(dev)] == 0)
    args[2] = args[2].clone()
    args[2][9] = host[0].shape[0] - 100            # n = nwin: runs off
    z, ok = bt.band_taps(*args, offsets, smax)
    assert not bool(ok) and torch.all(z[9] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_wide_v1_matches_plain(dev, iq):
    """33 offsets that are no progression launch the v1 wide kernel
    (COUNTS.v1, its taps in groups of 13) within the plain version's
    tolerance; the wide cluster kernel and v1 agree on a progression."""
    smax = 40
    offsets = tuple(int(o) for o in tap_offsets(16, 2))[:-1] + (37,)
    host, args = _band_inputs(320, iq, 541 + iq, dev, smax)
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, _ = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    assert (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) == (0, 1, 0)
    tol = profile_band.tolerance(host, 16376)
    assert bool(okk) and float((zk - zp).abs().max()) <= tol
    prog = tap_offsets(16, 2)
    out = torch.empty_like(zk)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    bt.launch_v1(*args, prog, smax, out, ok)
    zc, _ = bt.band_taps(*args, prog, smax)
    torch.cuda.synchronize()
    assert float((out - zc).abs().max()) <= 2 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("corrn,corrd", [(16, 2), (32, 1)])
def test_band_taps_wide_kernel_long_windows(dev, corrn, corrd, iq):
    """K1 past 25 taps at windows whose staged mixed samples do not fit
    the card's shared memory (1 ms at 65.472 Msps: ~9 bytes per segment
    sample, ~295 KB per CTA, against ~227 KB on an H100): the wide
    kernel recomputes the mix in every tap group, still one launch,
    within the plain version's tolerance, as the 13-tap kernel at the
    same windows."""
    smax, nn, nwin = corrn * corrd, 65472, 65480
    host, args = _band_inputs(32, iq, 601 + corrn + iq, dev, smax, nn=nn,
                              nwin=nwin)
    tol = profile_band.tolerance(host, nwin)
    for offsets in (tap_offsets(corrn, corrd), tap_offsets(6, corrd)):
        bt.COUNTS.reset()
        zk, okk = bt.band_taps(*args, offsets, smax)
        zp, okp = bt.band_taps_plain(*args, offsets, smax)
        torch.cuda.synchronize()
        assert (bt.COUNTS.kernel, bt.COUNTS.v1) == (1, 0)
        assert bool(okk) and bool(okp)
        assert float((zk - zp).abs().max()) <= tol
        assert torch.all(zk[~args[6]] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
def test_band_taps_wide_designs_match_plain(dev, iq):
    """tools/profile_band.py --wide's other design (the carrier recomputed
    in every tap group) against the plain version at 33 taps."""
    smax = 32
    offsets = tap_offsets(16, 2)
    host, args = _band_inputs(320, iq, 551 + iq, dev, smax)
    zp, _ = bt.band_taps_plain(*args, offsets, smax)
    out = torch.empty_like(zp)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    lib = profile_band.build(list(profile_band.WIDE_VARIANTS))["recompute"]
    profile_band.launcher(lib, offsets, smax, out, ok)(args)
    torch.cuda.synchronize()
    assert int(ok[0]) == 1
    assert float((out - zp).abs().max()) <= profile_band.tolerance(host,
                                                                   16376)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("corrn,corrd", WIDE)
def test_window_taps_wide_match_plain(dev, kind, corrn, corrd, iq):
    """K3 and the f32 instantiation at 33, 41 and 65 taps: one cluster
    launch per group of kernels.tap_plan (each about its centre lag), no
    v1, within the plain version's tolerance, repeats bit-identical."""
    smax = corrn * corrd
    offsets = tap_offsets(corrn, corrd)
    win, n, args = _win_inputs(kind, 64, iq, 560 + corrn + iq, dev, smax)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == (3, 0, 0)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)
    fn, _ = WINDOW_WRAPPERS[kind]
    z2 = fn(*args, offsets, smax)
    torch.cuda.synchronize()
    assert torch.equal(zk.view(torch.int32), z2.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_window_taps_wide_v1_matches_plain(dev, kind):
    """33 offsets that are no progression: the v1 kernel once per run of
    offsets (COUNTS.v1 3), within the plain version's tolerance."""
    smax = 40
    offsets = tuple(int(o) for o in tap_offsets(16, 2))[:-1] + (37,)
    win, n, args = _win_inputs(kind, 64, False, 571, dev, smax)
    zk, zp, counts = _win_run(kind, args, offsets, smax)
    assert counts == (0, 3, 0)
    assert float((zk - zp).abs().max()) <= _win_tol(kind, win, n)


@pytest.mark.cuda
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("corrn,corrd", WIDE)
def test_gram_taps_wide_matches_plain(dev, corrn, corrd, iq):
    """K2 at 33, 41 and 65 taps: the banded-Gram kernel (smax 32) or v1
    (smax 40) once per run of offsets, within the plain version's
    tolerance, and a wrapper call replayed from a CUDA graph equal to the
    eager one."""
    offsets = tuple(int(o) for o in tap_offsets(corrn, corrd))
    smax = corrn * corrd
    tol, args = _gram_inputs(64, 128, iq, 580 + corrn + iq, dev, smax)
    zk, zp, counts = _gram_run(args, offsets, smax)
    assert counts == ((0, 3, 0) if smax > gt.MAX_SMAX else (3, 0, 0))
    assert float((zk - zp).abs().max()) <= tol
    out = torch.empty_like(zk)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up before capture
        gt.launch(*args, offsets, smax, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gt.launch(*args, offsets, smax, out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), zk.view(torch.int32))


@pytest.mark.cuda
def test_ablation_taps_kernel_keeps_its_cap(dev):
    """K6's kernel takes at most 25 taps (its tool runs 13): 27 raise on
    the card before any launch; the plain version takes them."""
    rng = np.random.default_rng(591)
    B, nwin, smax = 4, 2000, 27
    offsets = tap_offsets(13, 2)
    host = (rng.integers(-128, 128, (B, nwin)).astype(np.float32),
            rng.choice(np.asarray([-1.0, 1.0], np.float32),
                       (B, nwin + 2 * smax)),
            rng.uniform(0, 1, B).astype(np.float32),
            np.full(B, 0.25, np.float32), np.full(B, nwin, np.float32))
    ab.COUNTS["full"].reset()
    with pytest.raises(ValueError, match="at most 25 taps"):
        ab.ablation_taps(*[torch.from_numpy(a).to(dev) for a in host],
                         offsets, smax)
    z = ab.ablation_taps(*[torch.from_numpy(a) for a in host], offsets, smax)
    assert z.shape == (B, 54)
    assert (ab.COUNTS["full"].kernel, ab.COUNTS["full"].v1) == (0, 0)


def _small_receiver(dev, tmp_path):
    """A receiver on the card over a 9 s capture of one GPS satellite
    (PRN 3 at 47 dB-Hz; PRN 5, absent, searched again every ACQSLEEP) at
    4.092 Msps: acquisition, pull-in, then steady blocks."""
    from gnsslib_tpu_torch.io.frontend import FileFrontend
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import Receiver
    f_sf, f_if, tow0, seconds = 4.092e6, 1.023e6, 352800.0, 9.0
    eph = sim.example_eph(prn=3, week=2200, toe_tow=tow0)
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    ch = sim.SimChannel(prn=3, doppler=800.0, code_phase=-75.0,
                        carr_phase=0.3, nav_bits=np.concatenate(
                            [pad, sim.lnav_bit_stream(eph, tow0 + 6.0)]))
    noise = sim.noise_std_for_cn0(1.0, 47.0, f_sf, DType.REAL)
    path = tmp_path / "sim.bin"
    x = sim.synthesize([ch], f_sf, f_if, DType.REAL, int(seconds * f_sf),
                       noise_std=noise, seed=5)
    sim.quantize_int8(x, 16.0).tofile(path)
    (tmp_path / "fend.ini").write_text(
        f"[FEND]\nTYPE=FILE\nCF1=1575.42e6\nSF1={f_sf}\nIF1={f_if}\n"
        f"DTYPE1=1\nFILE1={path}\n[TRACK]\nCORRN=4\nCORRD=2\nCORRP=2\n")
    (tmp_path / "rx.ini").write_text(
        f"[RCV]\nFENDCONF={tmp_path / 'fend.ini'}\n[CHANNEL]\nNCH=2\n"
        "PRN=3,5\nSYS=1,1\nCTYPE=1,1\nFTYPE=1,1\n[OUTPUT]\nOUTMS=400\n"
        "RINEX=0\n")
    cfg = load_ini(str(tmp_path / "rx.ini"))
    return Receiver(cfg, FileFrontend(cfg.files[0], cfg.fends[0]),
                    device=dev)


@pytest.mark.cuda
def test_receiver_device_spans(dev, tmp_path, monkeypatch):
    """On a card the receiver's span table carries the block programs'
    device time (``dev.track``, one per dispatched block, under the
    stage of the engine that ran it) and the searches' (``dev.acq``), by
    CUDA events read once the results are on the host: stepping calls no
    ``torch.cuda.synchronize``.  The build's split has its captures and
    graph pools."""
    rx = _small_receiver(dev, tmp_path)
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real(*a, **k)))
    s = rx.run_seconds()
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    rx.close()
    assert syncs == []
    st = s["spans"]["stages"]
    assert "steady" in st and "pullin" in st
    assert sum(st[k].get("dev.track", {}).get("n", 0)
               for k in st) == rx._ndisp
    for k in ("pullin", "steady"):
        assert st[k]["dev.track"]["s"] > 0
    acq = [st[k]["dev.acq"] for k in st if "dev.acq" in st[k]]
    assert sum(r["n"] for r in acq) >= 2 and all(r["s"] > 0 for r in acq)
    assert st["build"]["build.capture"]["n"] == 2
    assert st["build"]["build.capture"]["s"] > 0
    assert s["spans"]["counters"]["build.pool_bytes"] > 0


@pytest.mark.cuda
def test_steady_blocks_never_wait_for_the_whole_stream(dev, tmp_path):
    """The receiver's steady blocks, the searches among them and the final
    flush under ``torch.cuda.set_sync_debug_mode("error")``, which raises
    at every call that waits for a whole stream or the card (a blocking
    copy to the host, a copy from pageable memory, ``.item()``, a
    synchronize) and not at an event's wait: nothing raises, and each
    collect is counted beside its wait."""
    rx = _small_receiver(dev, tmp_path)
    end = rx.end_sample()
    while rx.can_step(end) and rx.spans.stage != "steady":
        rx.step_block()
    before = rx.spans.table()["stages"]["steady"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        while rx.can_step(end):
            rx.step_block()
            assert rx.spans.stage == "steady"
        rx.flush()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rx.close()
    st = rx.spans.table()["stages"]["steady"]
    assert st["step_block"]["n"] - before["step_block"]["n"] >= 5
    assert st["acq.wait"]["n"] > before.get("acq.wait", {"n": 0})["n"]
    for kind in ("track", "acq"):
        ready = st.get(f"{kind}.ready", {"n": 0})["n"]
        assert 0 <= ready <= st[f"{kind}.wait"]["n"]
