"""The helpers the port's kernel wrappers share (ops/kernels.py), on the
CPU: the tap-offset progression test that routes offsets to the cluster
kernels (K1, K3-K5) or their v1 kernels, and the window wrappers'
counters; and, in the kernels' sources, the one launch helper that opts
every launch in to its shared memory and the lines the profilers'
variants replace."""
import numpy as np
import pytest
import torch

from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.ops import kernels
from gnsslib_tpu_torch.ops import window_taps as wt
from gnsslib_tpu_torch.ops.correlator import tap_offsets
from gnsslib_tpu_torch.tools import profile_band, profile_window


@pytest.mark.parametrize("offsets,d", [
    ((0,), 1),
    ((0, -1, 1), 1),
    ((0, -3, 3, -6, 6), 3),
    (tuple(int(o) for o in tap_offsets(6, 3)), 3),
    (tuple(int(o) for o in tap_offsets(12, 4)), 4),
    (tuple(int(o) for o in tap_offsets(1, 7)), 7),
    ((0, -1, 2), None),           # not symmetric
    ((0, 3, -3), None),           # late tap before early
    ((3,), None),                 # one tap off the prompt
    ((0, -2, 2, -4, 5), None),    # uneven spacing
    ((0, 1, -1), None),           # negative step
    ((0, 0, 0), None),            # zero step
    ((0, -2, 2, -6, 6), None),    # a gap
])
def test_progression(offsets, d):
    """The step d of tap_offsets(corrn, d) offsets, None for any others;
    K1's wrapper and the window wrappers route by the one copy."""
    assert kernels.progression(offsets) == d
    assert bt.progression is kernels.progression
    assert wt.progression is kernels.progression


@pytest.mark.parametrize("name", ["correlate_windows", "correlate_windows8",
                                  "correlate_windows16"])
def test_window_counts_on_cpu(name):
    """Each window wrapper has its own kernel, v1 and plain counters in
    the registry; CPU tensors take the plain version and launch nothing."""
    counts = kernels.REGISTRY[name]
    counts.reset()
    assert counts.values() == {"kernel": 0, "plain": 0, "v1": 0}
    rng = np.random.default_rng(3)
    B, nwin, smax = 3, 64, 4
    bf16 = name == "correlate_windows16"
    win = torch.from_numpy(rng.integers(-8, 9, (B, nwin)).astype(np.float32))
    rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                     (B, nwin + 2 * smax)))
    win = win.to(torch.bfloat16) if bf16 else win
    rc = rc if bf16 else rc.to(torch.float32)
    rem = torch.zeros(B)
    ftot = torch.full((B,), 0.25)
    n = torch.full((B,), nwin, dtype=torch.int32)
    for offsets in ((0, -2, 2), (0, -1, 2)):     # progression or not
        z = getattr(wt, name)(win, rc, rem, ftot, n, offsets, smax)
        assert z.shape == (B, 6)
    assert counts.values() == {"kernel": 0, "plain": 2, "v1": 0}


def test_gram_counts_on_cpu():
    """K2's wrapper has its own kernel, v1 and plain counters in the
    registry; CPU tensors take the plain version and launch nothing, for
    geometries of either kernel (tile_plan or None)."""
    from gnsslib_tpu_torch.ops import gram_taps as gt
    counts = kernels.REGISTRY["gram_taps"]
    assert counts is gt.COUNTS
    counts.reset()
    assert counts.values() == {"kernel": 0, "plain": 0, "v1": 0}
    rng = np.random.default_rng(4)
    B, K = 2, 3
    win = torch.from_numpy(rng.integers(-8, 9, (B, K, 128)).astype(
        np.float32)).to(torch.bfloat16)
    rem = torch.zeros(B)
    ftot = torch.full((B,), 0.25)
    for smax, offsets in ((2, (0, -2, 2)), (40, (0, -40, 40))):
        assert (gt.tile_plan(K, smax) is None) == (smax > gt.MAX_SMAX)
        rc = torch.from_numpy(rng.choice(np.asarray([-1, 1], np.int8),
                                         (B, K * 128 + 2 * smax)))
        z = gt.gram_taps(win, None, rc, rem, ftot, offsets, smax)
        assert z.shape == (B, 6)
    assert counts.values() == {"kernel": 0, "plain": 2, "v1": 0}


@pytest.mark.parametrize("name", ["band_taps", "window_taps", "gram_taps",
                                  "ablation_taps"])
def test_every_launch_opts_in_through_the_helper(name):
    """Each kernel source, with its csrc/ headers inlined as the build
    hashes and the profilers edit it, includes no header left unread, has
    no launch that opts in only above 48 KB (static shared memory counts
    against that default too), and sets the shared-memory attribute and
    launches only in csrc/launch.cuh's launch_kernel."""
    from gnsslib_tpu_torch import cuda_build
    src = cuda_build.source(name)
    assert '#include "' not in src
    assert "48 * 1024" not in src and "<<<nwindows" not in src
    assert src.count("cudaFuncSetAttribute(") == 1
    assert src.count("cudaLaunchKernelEx(") == 1
    assert src.count("static size_t opted = 0;") >= 2


@pytest.mark.parametrize("tool,variant", [
    (t.__name__.rsplit(".", 1)[1], v) for t in (profile_band, profile_window)
    for v in t.VARIANTS])
def test_profiler_variant_sources(tool, variant):
    """Every variant of tools/profile_band.py and tools/profile_window.py
    finds the lines it replaces in its kernel's source with the csrc/
    headers inlined (K3-K5's cluster kernel body now lives in
    window_cluster.cuh) and builds 13 taps only; only the kernel itself
    (and the cluster size it has) is the source unchanged."""
    mod = {"profile_band": profile_band, "profile_window": profile_window}[
        tool]
    src = mod.variant_source(variant)
    assert '#include "' not in src
    assert "#define TAP_CASES(X) X(13)\n" in src
    base = mod.variant_source("kernel")
    assert (src == base) == (variant in ("kernel", "S2"))
