"""The port's factored-carrier correlator of fetched window rows (K2,
ops/gram_taps.py) against the JAX package's ``FastTracker._taps_fused``
with the Pallas kernel ``gram_usum_impl`` in interpret mode, on the CPU.

The JAX kernel also rounds each 128x128 Gram entry to bf16 before its
diagonal extraction; the port sums in f32, so the bound is test_fast.py's
between correlator backends: median error < 1e-3·scale, at most 3
outliers > 5e-3·scale, correlation > 0.999.

The card's banded-Gram kernel cannot run here; its decomposition can: the
band of the Gram over the n-tiles ``tile_plan`` lists, then the diagonal
sums, is held against ``gram_taps_plain``, and the profiler's source
variants are checked to find the lines they replace."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_fast
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.track import FastTracker as JaxFastTracker
from gnsslib_tpu.track import TrackConfig as JaxTrackConfig
from gnsslib_tpu.track import Tracker as JaxTracker
from gnsslib_tpu_torch.ops import gram_taps as gt
from gnsslib_tpu_torch.ops.correlator import tap_offsets
from gnsslib_tpu_torch.tools import profile_gram
from gnsslib_tpu_torch.track import TrackConfig, Tracker

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _rows(iq, B, seed):
    """A JAX FastTracker and masked bf16-exact window rows at its shapes
    (K = 33 rows: the JAX side pads them to 64)."""
    dtype = DType.IQ if iq else DType.REAL
    jtrk = JaxTracker(JaxTrackConfig(4, 2, 2), [7, 8], [CodeType.L1CA] * 2,
                      test_fast.F_SF, test_fast.F_IF, dtype)
    jf = JaxFastTracker(jtrk, use_pallas=False)
    K = jf._fetch_nr - 1
    rng = np.random.default_rng(seed)
    n = rng.integers(jtrk.n_nom - 2, jtrk.n_nom + 3, B)
    keep = np.arange(K * 128).reshape(K, 128)[None] < n[:, None, None]
    wi = rng.integers(-40, 41, (B, K, 128)).astype(np.float32) * keep
    wq = rng.integers(-40, 41, (B, K, 128)).astype(np.float32) * keep
    rc = rng.choice(np.asarray([-1, 1], np.int8), (B, jtrk.next))
    rem = rng.uniform(0, 1, B).astype(np.float32)
    ftot = rng.uniform(-0.5, 0.5, B).astype(np.float32)
    return jtrk, jf, wi, (wq if iq else None), rc, rem, ftot


@pytest.mark.parametrize("iq", [False, True])
def test_gram_taps_plain_matches_taps_fused(iq):
    jtrk, jf, wi, wq, rc, rem, ftot = _rows(iq, 20, 3 + iq)
    jw = jnp.asarray(wi, jnp.bfloat16)
    if iq:
        jw = (jw, jnp.asarray(wq, jnp.bfloat16))
    zj = np.asarray(jf._taps_fused(jw, jnp.asarray(rc), jnp.asarray(rem),
                                   jnp.asarray(ftot), interpret=True))
    gt.COUNTS.reset()
    zt = gt.gram_taps(torch.from_numpy(wi).to(torch.bfloat16),
                      None if wq is None else
                      torch.from_numpy(wq).to(torch.bfloat16),
                      torch.from_numpy(rc), torch.from_numpy(rem),
                      torch.from_numpy(ftot), jtrk.offsets, jtrk.smax)
    assert gt.COUNTS.plain == 1 and gt.COUNTS.kernel == 0
    zt = zt.numpy()
    assert zt.shape == zj.shape
    d = np.abs(zt - zj)
    scale = np.max(np.abs(zj))
    assert int(np.sum(d > 5e-3 * scale)) <= 3, float(d.max())
    assert np.median(d) < 1e-3 * scale
    assert np.corrcoef(zt.ravel(), zj.ravel())[0, 1] > 0.999


def test_gram_taps_takes_wide_tap_geometry():
    """The JAX split-Gram layout needs 2*smax <= 64; the port's K2 has no
    such layout: a 25-tap, smax=36 geometry gives the direct tap sums."""
    trk = Tracker(TrackConfig(12, 3, 6), [7], [CodeType.L1CA],
                  test_fast.F_SF, test_fast.F_IF, DType.REAL, device="cpu")
    assert 2 * trk.smax > 64
    rng = np.random.default_rng(5)
    B, K = 3, (trk.nwin + 127) // 128
    wi = torch.from_numpy(rng.integers(-8, 9, (B, K, 128)).astype(
        np.float32)).to(torch.bfloat16)
    rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                     (B, trk.next)))
    zero = torch.zeros(B)
    z = gt.gram_taps(wi, None, rc, zero, zero, trk.offsets, trk.smax)
    # rem = ftot = 0: no mixing, so cos taps are plain shifted dot products
    x = wi.float().reshape(B, -1)
    pad = torch.zeros((B, K * 128 + 2 * trk.smax))
    pad[:, :trk.next] = rc.float()
    for t, o in enumerate(trk.offsets):
        ref = (x * pad[:, trk.smax + o:trk.smax + o + K * 128]).sum(1)
        assert torch.equal(z[:, 2 * t], ref)
        assert torch.all(z[:, 2 * t + 1] == 0)


def test_gram_taps_checks_inputs():
    jtrk, _, wi, _, rc, rem, ftot = _rows(False, 4, 1)
    args = [torch.from_numpy(wi).to(torch.bfloat16), None,
            torch.from_numpy(rc), torch.from_numpy(rem),
            torch.from_numpy(ftot)]
    off, smax = jtrk.offsets, jtrk.smax
    with pytest.raises(TypeError, match="win_i must be torch.bfloat16"):
        gt.gram_taps(args[0].float(), *args[1:], off, smax)
    with pytest.raises(ValueError, match="win_q shape"):
        gt.gram_taps(args[0], args[0][:2].contiguous(), *args[2:], off, smax)
    with pytest.raises(ValueError, match=r"win_i must be \(B, K, 128\)"):
        gt.gram_taps(args[0][..., :64].contiguous(), *args[1:], off, smax)
    with pytest.raises(ValueError, match="smax"):
        gt.gram_taps(*args, [0, smax + 1, -smax - 1], smax)


def _banded_gram_taps(win_i, win_q, rc, rem, ftot, offsets, smax):
    """The banded-Gram kernel's decomposition in plain torch: the rows
    padded with zero rows to whole 16-row steps, per m-tile of 16 lanes j
    the Gram ``U = wc^T B`` (``bmm``) over exactly the n-tiles
    ``gt.tile_plan`` lists, ``B[k, l] = r[128 k + l]`` (0 past the row's
    end), the diagonal sums of the band in m-tile order, then the taps."""
    B, K, L = win_i.shape
    plan = gt.tile_plan(K, smax)
    Kp = -(-K // gt.K_STEP) * gt.K_STEP
    ncols = max(c + gt.N_TILE for cols in plan for c in cols)
    rcf = torch.zeros((B, L * (Kp - 1) + ncols), dtype=torch.float64)
    m = min(rcf.shape[1], rc.shape[1])
    rcf[:, :m] = rc[:, :m].double()
    bmat = torch.stack([rcf[:, L * k:L * k + ncols] for k in range(Kp)], 1)
    diag = torch.zeros((2, B, 2 * smax + 1), dtype=torch.float64)
    for cs, w in enumerate(gt.mixed_rows(win_i, win_q, rem, ftot)):
        a = torch.zeros((B, Kp, L), dtype=torch.float64)
        a[:, :K] = w.double()
        for mt, cols in enumerate(plan):
            j0 = gt.M_TILE * mt
            lcols = [c + n for c in cols for n in range(gt.N_TILE)]
            u = torch.bmm(a[:, :, j0:j0 + gt.M_TILE].transpose(1, 2),
                          bmat[:, :, lcols])         # (B, 16, 8 * tiles)
            rel = torch.as_tensor(lcols) - j0
            for jj in range(gt.M_TILE):
                # lag d of lane j0 + jj is column jj + d of the m-tile
                idx = [int((rel == jj + d).nonzero()) for d in
                       range(2 * smax + 1)]
                diag[cs] += u[:, jj, idx]
    return torch.stack([diag[cs][:, smax + o] for o in offsets
                        for cs in (0, 1)], 1)


@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("K", [33, 128])
@pytest.mark.parametrize("smax,offsets", [
    (1, (0, -1, 1)),
    (18, tuple(int(o) for o in tap_offsets(6, 3))),
    (36, tuple(int(o) for o in tap_offsets(12, 3))),
])
def test_banded_gram_decomposition_matches_plain(smax, offsets, K, iq):
    """The banded Gram over the tile plan's n-tiles, then the diagonal
    sums, equals gram_taps_plain to f32 rounding (1e-6 of each window's
    L1 norm of wc and ws): an n-tile missing from the plan or a lag off by
    one moves a tap by a replica product, 1 or more."""
    rng = np.random.default_rng(100 * smax + K + iq)
    B = 3
    n = rng.integers(K * 128 - 200, K * 128 + 1, B)
    keep = np.arange(K * 128).reshape(K, 128)[None] < n[:, None, None]
    rows = [torch.from_numpy((rng.integers(-40, 41, (B, K, 128)) * keep)
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(2)]
    wi, wq = rows[0], rows[1] if iq else None
    # rows shorter than the rows' extent: samples past next count as 0
    rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                     (B, K * 128 + 2 * smax - 5)))
    rem = torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32))
    ftot = torch.from_numpy(rng.uniform(-0.5, 0.5, B).astype(np.float32))
    zp = gt.gram_taps_plain(wi, wq, rc, rem, ftot, offsets, smax)
    zb = _banded_gram_taps(wi, wq, rc, rem, ftot, offsets, smax)
    wc, ws = gt.mixed_rows(wi, wq, rem, ftot)
    l1 = (wc.abs() + ws.abs()).sum(dim=(1, 2)).double()
    assert torch.all((zb - zp.double()).abs().max(dim=1).values
                     <= 1e-6 * l1)


@pytest.mark.parametrize("K,smax,tiles", [
    (128, 18, 7), (33, 36, 11), (128, 0, 2), (1, 4, 3), (256, 20, 7),
    (128, 37, None), (257, 18, None),
])
def test_tile_plan(K, smax, tiles):
    """The n-tiles each m-tile reads: ceil((16 + 2 smax) / 8) of them from
    the m-tile's first lane, covering the lags [0, 2 smax] of its 16 lanes;
    None (the v1 kernel) past the largest instantiation (smax 36, 256
    rows)."""
    plan = gt.tile_plan(K, smax)
    if tiles is None:
        assert plan is None
        return
    assert len(plan) == 128 // gt.M_TILE
    for m, cols in enumerate(plan):
        assert len(cols) == tiles
        assert cols == tuple(16 * m + 8 * n for n in range(tiles))
        covered = {c + e for c in cols for e in range(8)}
        need = {16 * m + jj + d for jj in range(16)
                for d in range(2 * smax + 1)}
        assert need <= covered


@pytest.mark.parametrize("variant", sorted(profile_gram.VARIANTS))
def test_profile_gram_variant_sources(variant):
    """Every variant of tools/profile_gram.py finds the lines it replaces
    in csrc/gram_taps.cu (with its staging header inlined) and builds the
    main path's 7 n-tiles only; only the kernel itself is the source
    unchanged."""
    from gnsslib_tpu_torch import cuda_build
    src = profile_gram.variant_source(variant)
    assert "#include \"stage_async.cuh\"" not in src
    assert "int stage_async(" in src
    assert "#define TILE_CASES(X) X(7)\n" in src
    base = profile_gram.variant_source("kernel")
    assert (src == base) == (variant in ("kernel", "S2"))
    assert base.count("gram_taps_mma_kernel") >= 2
    assert cuda_build.source("gram_taps").count("mma.sync.aligned.m16n8k16"
                                                ".row.col.f32.bf16.bf16") == 1
