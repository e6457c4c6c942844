"""The block programs of the port's trackers (``track/program.py``) on the
CPU, where the capture is left out and the eager body runs over the same
static buffers that a card's CUDA graph replays: the program's blocks are
bit-identical to the eager loop (``run_block_eager``), blocks started back
to back with host edits between them give what blocks run one at a time
give, and nothing a caller holds aliases the program's buffers.  The card
counterparts (graph replay against eager) are in ``test_torch_cuda.py``;
the trackers' agreement with the JAX package is held by
``test_torch_fast.py``, ``test_torch_track.py`` and
``test_torch_receiver.py``, which run through the programs."""
import numpy as np
import pytest
import torch

from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.constants import CodeType, DType
from gnsslib_tpu_torch.ops import ablation_taps  # noqa: F401  (registers)
from gnsslib_tpu_torch.ops import band_taps as bt
from gnsslib_tpu_torch.ops import kernels
from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker
from gnsslib_tpu_torch.track.program import CARRY_FIELDS
from gnsslib_tpu_torch.track.state import STATE_FIELDS



@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for bit-for-bit comparisons: MKL may otherwise pick
    another thread count for a product when the machine is loaded, and
    with it another order of the product's sums."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F_SF, F_IF = 4.092e6, 1.023e6
PRNS = [3, 9, 14]                  # 3 and 9 visible, 14 absent
SIGNAL = {3: (800, 900.0), 9: (2100, -1500.0)}   # delay, Doppler
ENGINES = ["pullin", "band", "pallas", "fused", "xla"]


@pytest.fixture(scope="module")
def scene():
    """A 0.6 s capture of two satellites, a tracker for three channels, and
    a state with both visible channels pulled in and bit-synced."""
    ch = [sim.SimChannel(prn=p, doppler=dop,
                         code_phase=-d * 1.023e6 / F_SF)
          for p, (d, dop) in SIGNAL.items()]
    noise = sim.noise_std_for_cn0(1.0, 45.0, F_SF, DType.REAL)
    x = np.asarray(sim.synthesize(ch, F_SF, F_IF, DType.REAL,
                                  int(0.6 * F_SF), noise_std=noise, seed=4),
                   np.float32)
    block = torch.from_numpy(x)
    trk = Tracker(TrackConfig(4, 2, 2), PRNS, [CodeType.L1CA] * 3, F_SF,
                  F_IF, DType.REAL, device="cpu")
    st = trk.start_channels(trk.init_state(), [0, 1],
                            [d for d, _ in SIGNAL.values()],
                            [-dop for _, dop in SIGNAL.values()])
    st, _ = trk.run_block_eager(st, block, 100)
    for c in range(2):
        st = trk.set_bit_sync(st, c, 0)
    return trk, st, block


def _engine(trk, name):
    if name == "pullin":
        return trk
    fast = FastTracker(trk)
    fast.corr = name
    return fast


def _same(a, b) -> bool:
    """Bit-identical tensors (floats compared as their bits)."""
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _assert_same_block(ra, rb):
    (sa, (fa, ia)), (sb, (fb, ib)) = ra, rb
    for k in STATE_FIELDS:
        assert _same(getattr(sa, k), getattr(sb, k)), k
    assert _same(fa, fb) and _same(ia, ib)


@pytest.mark.parametrize("name", ENGINES)
def test_program_matches_eager(scene, name):
    """A block through the program (the static-buffer path a card
    replays) gives the eager loop's state and telemetry bit for bit; the
    program is built once for its key and reused."""
    trk, st, block = scene
    eng = _engine(trk, name)
    nsteps = 40
    n0 = len(eng.programs)     # the pull-in tracker is shared between tests
    got = eng.run_block_start(st, block, nsteps)
    _assert_same_block(got, eng.run_block_eager(st, block, nsteps))
    assert len(eng.programs) == n0 + 1
    prog = eng.program(nsteps, block.shape)
    assert prog.graph is None and prog.replays == 1
    _assert_same_block(eng.run_block_start(st, block, nsteps), got)
    assert len(eng.programs) == n0 + 1 and prog.replays == 2


@pytest.mark.parametrize("name", ["pullin", "band"])
def test_pipelined_blocks_with_host_edits_match_one_at_a_time(scene, name):
    """Four blocks queued two deep (each started before the one before it
    is collected), with the receiver's host edits between them — a channel
    started, a channel bit-synced, a channel restarted after a reset, the
    sample window rebased — give the telemetry and end state of the eager
    loop run one block at a time."""
    trk, st, block = scene
    eng = _engine(trk, name)
    nsteps, adv = 20, 20 * trk.n_nom
    base = 100 * trk.n_nom              # the scene's pull-in consumed this
    st0 = trk.rebase(st, base)

    def edits(st, k):
        st = trk.rebase(st, adv)
        if k == 0:                      # a channel (the absent PRN) starts
            st = trk.start_channels(st, [2], [500], [250.0])
        if k == 1:
            st = trk.set_bit_sync(st, 2, 0)
        if k == 2:                      # a lost channel restarts
            st = trk.start_channels(st, [0], [900], [-900.0])
        return st

    def run(start):
        st, handles = st0, []
        for k in range(4):
            blk = block[base + k * adv:base + (k + 6) * adv]
            st, h = start(st, blk, nsteps)
            handles.append(h)
            st = edits(st, k)
        return st, handles

    n0 = len(eng.programs)
    st_p, pipelined = run(eng.run_block_start)
    st_e, eager = run(eng.run_block_eager)
    for k in STATE_FIELDS:
        assert _same(getattr(st_p, k), getattr(st_e, k)), k
    for hp, he in zip(pipelined, eager):
        assert _same(hp[0], he[0]) and _same(hp[1], he[1])
    outs = [eng.run_block_collect(h) for h in pipelined]
    assert [o.loc.shape for o in outs] == [(nsteps, 3)] * 4
    assert len(eng.programs) == n0 + 1


def test_returned_state_and_telemetry_do_not_alias(scene):
    """Neither the returned state nor the handle shares storage with the
    program's buffers, and the next block leaves both as they were."""
    trk, st, block = scene
    fast = _engine(trk, "band")
    st1, h1 = fast.run_block_start(st, block, 30)
    prog = next(iter(fast.programs.values()))
    owned = {getattr(prog._state, k).untyped_storage().data_ptr()
             for k in STATE_FIELDS}
    owned |= {t.untyped_storage().data_ptr()
              for t in (prog._block, prog._packf, prog._packi)}
    held = [getattr(st1, k) for k in STATE_FIELDS] + list(h1)
    assert not owned & {t.untyped_storage().data_ptr() for t in held}
    keep = [t.clone() for t in held]
    st2, h2 = fast.run_block_start(st1, block, 30)
    assert all(_same(a, b) for a, b in zip(held, keep))
    assert not _same(h1[0], h2[0])


def test_launch_counter_registry():
    """The wrappers' counters are registered by name; a snapshot, the
    counts since it, restore and add are what a program uses to count a
    replay's launches."""
    assert {"band_taps", "gram_taps", "correlate_windows",
            "correlate_windows8", "correlate_windows16",
            "ablation_taps[full]"} <= set(kernels.REGISTRY)
    assert kernels.REGISTRY["band_taps"] is bt.COUNTS
    before = kernels.snapshot()
    bt.COUNTS.kernel += 3
    bt.COUNTS.v1 += 1
    added = kernels.since(before)
    assert added == {"band_taps": {"kernel": 3, "v1": 1}}
    kernels.restore(before)
    assert kernels.snapshot() == before
    kernels.add(added)
    kernels.add(added)
    assert kernels.since(before) == {"band_taps": {"kernel": 6, "v1": 2}}
    kernels.restore(before)
    with pytest.raises(ValueError, match="exists"):
        kernels.LaunchCounts("band_taps")


def test_program_rejects_other_device_and_shape(scene):
    trk, st, block = scene
    prog = trk.program(10, block.shape)
    with pytest.raises(ValueError, match="block shape"):
        prog.load(st, block[:-1])
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="state is on meta"):
        prog.load(st.replace(loc=st.loc.to(meta)), block)
    assert set(CARRY_FIELDS) < set(STATE_FIELDS)


def test_dropped_engine_frees_its_programs_at_once(scene):
    """An engine and its programs form no reference cycle: dropping the
    engine frees them at once, never later inside the cyclic collector
    (which could then destroy a graph in the middle of another program's
    capture, where that is not permitted)."""
    import gc
    import weakref
    trk, st, block = scene
    fast = _engine(trk, "band")
    prog = weakref.ref(fast.program(10, block.shape))
    gc.disable()
    try:
        del fast
        assert prog() is None
    finally:
        gc.enable()
