"""K6, the correlator ablation: each plain version of
``gnsslib_tpu_torch.ops.ablation_taps`` against its Pallas body in the JAX
package's ``tools/profile_kernel.py`` (imported by path, run in interpret
mode on the CPU), and the port's profiler on the CPU."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu_torch.ops import ablation_taps as ab
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
