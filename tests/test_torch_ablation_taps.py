"""K6, the correlator ablation: each plain version of
``gnsslib_tpu_torch.ops.ablation_taps`` against its Pallas body in the JAX
package's ``tools/profile_kernel.py`` (imported by path, run in interpret
mode on the CPU), and the port's profiler on the CPU.

The card's cluster kernel cannot run here; its plan and its decomposition
can: ``plan`` for every variant, the chains, segments and column map held
against the plain versions, and the wrapper's routing between the cluster
kernel and the v1 kernel with the library replaced by a recorder."""
import functools
import importlib.util
import os
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu_torch.ops import ablation_taps as ab
from gnsslib_tpu_torch.ops.carrier import TWO_PI
from gnsslib_tpu_torch.ops.correlator import tap_offsets
from gnsslib_tpu_torch.ops.kernels import REGISTRY, V1Counts
from gnsslib_tpu_torch.ops.nco import frac
from gnsslib_tpu_torch.tools import profile_kernel as tpk

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, NWIN, SMAX = 16, 1000, 36
OFFSETS = tuple(range(-18, 19, 3))
W = NWIN + 2 * SMAX + 1664


@pytest.fixture(scope="module")
def jpk():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_kernel", os.path.join(ROOT, "tools", "profile_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed):
    rng = np.random.default_rng(seed)
    win = rng.integers(-8, 8, (B, NWIN)).astype(np.float32)
    rc = rng.choice([-1.0, 1.0], (B, W)).astype(np.float32)
    rem = rng.random(B).astype(np.float32)
    ftot = (0.25 + 0.01 * rng.random(B)).astype(np.float32)
    # valid bounds below, at and between integers
    n = np.concatenate([np.full(B // 2, NWIN - 80, np.float32),
                        rng.uniform(NWIN - 200, NWIN + 5, B - B // 2)
                        .astype(np.float32)])
    return win, rc, rem, ftot, n


@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_plain_matches_pallas_body(jpk, monkeypatch, variant):
    """Each plain version against its Pallas body in interpret mode, to
    1e-5 of the window's L1 norm (each tap sums at most nwin products
    bounded by |w_i|, since |carrier| <= 1 and |replica| = 1; f32 sums in
    either order stay far inside that)."""
    monkeypatch.setattr(jpk.pl, "pallas_call",
                        functools.partial(jpk.pl.pallas_call, interpret=True))
    win, rc, rem, ftot, n = _inputs(3 + ab.VARIANTS.index(variant))
    body = getattr(jpk, f"k_{variant}")
    run = jpk.make(body, 2 * len(OFFSETS), B, NWIN, W, SMAX, OFFSETS)
    want = np.asarray(run(win, rc, rem, ftot, n))
    ab.COUNTS[variant].reset()
    got = ab.ablation_taps(*[torch.from_numpy(a) for a in
                             (win, rc, rem, ftot, n)], OFFSETS, SMAX,
                           variant).numpy()
    assert ab.COUNTS[variant].plain == 1 and ab.COUNTS[variant].kernel == 0
    assert got.shape == want.shape == (B, 2 * len(OFFSETS))
    l1 = np.abs(win).sum(axis=1)
    err = np.abs(got - want).max(axis=1)
    assert np.all(err <= 1e-5 * l1), (err.max(), l1.min())
    if variant == "onetap":
        assert np.array_equal(got, np.tile(got[:, :2], len(OFFSETS)))


def test_wrapper_rejects_bad_inputs():
    win, rc, rem, ftot, n = [torch.from_numpy(a) for a in _inputs(1)]
    with pytest.raises(ValueError, match="variant"):
        ab.ablation_taps(win, rc, rem, ftot, n, OFFSETS, SMAX, "fast")
    with pytest.raises(TypeError, match="n must be torch.float32"):
        ab.ablation_taps(win, rc, rem, ftot, n.int(), OFFSETS, SMAX)
    with pytest.raises(ValueError, match="rc must be"):
        ab.ablation_taps(win, rc[:, :NWIN + 1000], rem, ftot, n, OFFSETS,
                         SMAX, "aligned")
    with pytest.raises(ValueError, match="odd tap count"):
        ab.ablation_taps(win, rc, rem, ftot, n, OFFSETS[:12], SMAX)


def test_profiler_runs_on_cpu():
    """``profile(cpu)`` times every variant (plain versions, host clock)
    and the eager scan; the CUDA graph needs the card."""
    res = tpk.profile("cpu", reps=1, B=8, nwin=600, iters=3,
                      log=lambda m: None)
    assert list(res) == list(ab.VARIANTS)
    for v, rec in res.items():
        assert np.isfinite(rec["ms"]) and rec["ms"] > 0, v
        assert np.isfinite(rec["eager_ms_per_iter"]), v
        assert rec["graph_ms_per_iter"] is None
        assert rec["launches"] == 0 and rec["plain"] > 0


def test_profiler_refuses_without_card(capsys):
    if torch.cuda.is_available():                     # pragma: no cover
        pytest.skip("a card is present")
    assert tpk.main(["--reps", "1"]) == 2
    assert "no CUDA card" in capsys.readouterr().err


# --- the cluster kernel's plan and decomposition, on the CPU ------------ #
J, S = 33, 2          # csrc/window_cluster.cuh's kJ and kCluster
K6 = tuple(range(-18, 19, 3))
TAP13 = tuple(int(o) for o in tap_offsets(6, 3))
SLOTS = tuple(2 * (6 - m) - 1 if m < 6 else 2 * (m - 6) for m in range(13))
SLOTS = (SLOTS[:6] + (0,) + SLOTS[7:])      # slot_of(m, 6): lag m's tap


@pytest.mark.parametrize("variant,offsets,smax,want", [
    # the TPU tool's ascending offsets: lags 18..54, columns in lag order
    ("full", K6, 36, (18, 3, tuple(range(13)))),
    ("nosin", K6, 36, (18, 3, tuple(range(13)))),
    ("onetap", K6, 36, (18, 3, (0,))),
    ("aligned", K6, 36, (0, 128, tuple(range(13)))),
    # tap_offsets order: lag m is tap slot_of(m, 6); onetap's tap 0 is the
    # prompt, lag smax, still at d = 3
    ("full", TAP13, 18, (0, 3, SLOTS)),
    ("nosin", TAP13, 18, (0, 3, SLOTS)),
    ("onetap", TAP13, 18, (18, 3, (0,))),
    ("aligned", TAP13, 18, (0, 128, tuple(range(13)))),
    # a single tap: d = 1
    ("full", (0,), 5, (5, 1, (0,))),
    ("onetap", (2,), 5, (7, 1, (0,))),
    ("aligned", (0,), 5, (0, 1, (0,))),
    # lags at 128 t, as offsets
    ("full", (-128, 0, 128), 128, (0, 128, (0, 1, 2))),
    ("nosin", (128, -128, 0), 128, (0, 128, (1, 2, 0))),
    # no progression: the v1 kernel (aligned's lags are 128 t whatever
    # the offsets)
    ("full", (0, -1, 2), 2, None),
    ("nosin", (0, -2, 2, -4, 5), 5, None),
    ("onetap", (0, -1, 2), 2, None),
    ("full", (0, 0, 3), 3, None),
    ("aligned", (0, -1, 2), 2, (0, 128, (0, 1, 2))),
])
def test_plan(variant, offsets, smax, want):
    """The cluster kernel's (base, d, output column of each lag), or None
    for lags that sorted form no progression with step d >= 1."""
    assert ab.plan(variant, offsets, smax) == want
    p = ab.plan(variant, offsets, smax)
    if p is not None and variant != "onetap":
        base, d, cols = p
        lg = ab.lags(variant, offsets, smax)
        assert [lg[c] for c in cols] == [base + m * d
                                         for m in range(len(cols))]


def _chain_taps(variant, win, rc, rem, ftot, n, offsets, smax):
    """The cluster kernel's decomposition in plain torch (float64 sums of
    the plain version's f32 carrier): each window split into S segments of
    whole tiles of J*d samples, chain u of a segment at tile u // d and
    residue u % d reading replica values base + (j + m)*d past its sample
    j, every chain's J samples (those below the segment's valid count),
    the chains' sums in thread order, the ranks' in rank order, then the
    output columns by the kernel's map ``sources`` (onetap's pair to
    every tap).  Asserts that
    the chains cover every valid sample once and read only the staged
    replica values."""
    base, d, cols = ab.plan(variant, offsets, smax)
    NT, T = len(cols), len(offsets)
    B, nwin = win.shape
    tile = J * d
    seg = -(-(-(-nwin // S)) // tile) * tile
    nrep = seg + (NT - 1) * d                  # staged replica values
    u = torch.arange(seg // tile * d)
    s0 = (u // d) * tile + u % d               # chain starts
    s = s0[:, None] + d * torch.arange(J)[None, :]          # (chains, J)
    out = torch.zeros((B, 2 * T), dtype=torch.float64)
    for b in range(B):
        nb = int(np.ceil(min(max(float(n[b]), 0.0), nwin)))
        total = torch.zeros(2 * NT, dtype=torch.float64)
        seen = torch.zeros(nwin, dtype=torch.int64)
        for r in range(S):                     # rank order
            seg0 = r * seg
            lim = max(0, min(nb - seg0, seg))
            ok = (s < lim) & (s0[:, None] < lim)
            i = (seg0 + s)[ok]                 # window indices, chain order
            seen += torch.bincount(i, minlength=nwin)
            fi = i.to(torch.float32)
            ph = frac(frac(ftot[b] * fi) + rem[b])
            if variant == "nosin":
                c, sn = 1.0 - ph * ph, ph
            else:
                c, sn = torch.cos(TWO_PI * ph), torch.sin(TWO_PI * ph)
            x = win[b, i].double()
            for m in range(NT):
                q = s[ok] + m * d              # staged replica value index
                assert bool(torch.all(q < nrep))
                rep = rc[b, seg0 + base + q].double()
                total[2 * m] += (x * c.double() * rep).sum()
                total[2 * m + 1] += (x * sn.double() * rep).sum()
        assert torch.equal(seen, (torch.arange(nwin) < nb).long())
        for j, m in enumerate(ab.sources(cols, T)):     # the kernel's map
            out[b, 2 * j:2 * j + 2] = total[2 * m:2 * m + 2]
    return out


@pytest.mark.parametrize("offsets,smax", [
    ((0,), 4),                          # 1 tap
    ((-3, 0, 3), 3),                    # 3 taps
    (tuple(range(-36, 37, 3)), 36),     # 25 taps
    (TAP13, 18),                        # tap_offsets order
])
@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_chain_decomposition_matches_plain(variant, offsets, smax):
    """The cluster kernel's chains, segments and column map against the
    plain version, to 1e-6 of each window's L1 norm (f64 sums against f32
    ones): a chain missing, a lag off by one or a column in the wrong
    place moves a tap by a whole product, 1 or more.  8 windows of 700
    samples (not a multiple of any tile), valid bounds fractional, zero,
    negative, at a segment's edges and beyond nwin."""
    rng = np.random.default_rng(len(offsets) + ab.VARIANTS.index(variant))
    B, nwin = 8, 700
    lg = ab.lags(variant, offsets, smax)
    W = nwin + max(lg) + 5
    win = torch.from_numpy(rng.integers(-8, 9, (B, nwin)).astype(np.float32))
    rc = torch.from_numpy(rng.choice([-1.0, 1.0], (B, W)).astype(np.float32))
    rem = torch.from_numpy(rng.random(B).astype(np.float32))
    ftot = torch.from_numpy((0.25 + 0.01 * rng.random(B)).astype(np.float32))
    d = ab.plan(variant, offsets, smax)[1]
    seg = -(-(-(-nwin // S)) // (J * d)) * (J * d)
    n = torch.tensor([0.0, -3.0, 0.25, 437.3, seg - 0.5, seg, seg + 0.7,
                      nwin + 5.0], dtype=torch.float32)
    zp = ab.PLAIN[variant](win, rc, rem, ftot, n, offsets, smax)
    zc = _chain_taps(variant, win, rc, rem, ftot, n, offsets, smax)
    l1 = win.abs().sum(dim=1).double()
    assert torch.all((zc - zp.double()).abs().max(dim=1).values <= 1e-6 * l1)
    assert torch.all(zc[:2] == 0)


class _Lib:
    """A stand-in for the kernel library: records which entry point was
    called with which arguments, and launches nothing."""

    def __init__(self):
        self.calls = []

    def ablation_taps_launch(self, *args):
        self.calls.append(("kernel", args))
        return 0

    def ablation_taps_v1_launch(self, *args):
        self.calls.append(("v1", args))
        return 0


@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_v1_counts_route_by_plan(monkeypatch, variant):
    """Each variant counts its wrapper's calls in a V1Counts: CPU tensors
    take the plain version; on a card, lags that plan() plans launch the
    cluster kernel with its base, d and columns (``kernel``), any others
    the v1 kernel (``v1``).  The library is replaced by a recorder, so the
    route is checked here without a card."""
    counts = ab.COUNTS[variant]
    assert isinstance(counts, V1Counts) and REGISTRY[counts.name] is counts
    counts.reset()
    win, rc, rem, ftot, n = [torch.from_numpy(a) for a in _inputs(2)]
    ab.ablation_taps(win, rc, rem, ftot, n, OFFSETS, SMAX, variant)
    assert counts.values() == {"kernel": 0, "plain": 1, "v1": 0}
    lib = _Lib()
    monkeypatch.setattr(ab, "_library", lambda: lib)
    monkeypatch.setattr(ab, "route", lambda op, device: "kernel")
    monkeypatch.setattr(ab, "stream_of", lambda device: 0)
    monkeypatch.setattr(ab.torch.cuda, "device", lambda d: nullcontext())
    odd = (0, -3, 6, 9, -12, 3, 12, -6, 15, -9, 18, -18, 21)   # no -15
    for offsets in (OFFSETS, odd):
        ab.ablation_taps(win, rc, rem, ftot, n, offsets, SMAX, variant)
    want_v1 = 0 if variant == "aligned" else 1
    assert counts.values() == {"kernel": 2 - want_v1, "plain": 1,
                               "v1": want_v1}
    assert [c[0] for c in lib.calls] == ["kernel",
                                         "kernel" if variant == "aligned"
                                         else "v1"]
    args = lib.calls[0][1]
    base, d, cols = ab.plan(variant, OFFSETS, SMAX)
    src = ab.sources(cols, len(OFFSETS))
    assert args[0] == ab.VARIANTS.index(variant)
    assert args[8:11] == (len(OFFSETS), base, d)
    assert args[11] == ab.device_offsets(src, win.device).data_ptr()
    # the kernel's map: output tap j takes lag src[j]; onetap's all lag 0
    assert src == ((0,) * len(OFFSETS) if variant == "onetap" else
                   tuple(cols.index(j) for j in range(len(OFFSETS))))
