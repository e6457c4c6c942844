"""The port's tracking block follows its channels, so a stream of any
length keeps every window inside its block.

A fixed block that starts one code period before the nominal cursor
``base`` (with the nominal rebase of
``Tracker.rebase``) loses a channel whose code period is shorter than
nominal once its period boundary has drifted a period early (~400 s at
4 kHz of Doppler), and a channel whose period is longer once it reaches
the block's tail; the steady FastTracker's band correlator then flags the
block and ``run_block_collect`` raises.  Here two channels start at those
edges of such a block (3 samples after its first sample with +4 kHz of
code Doppler, and 3 samples inside the tail its windows may reach with
-4 kHz) on a 4.092 Msps capture with 200-period blocks, so the drift of
~2 samples per block reaches the edge within a few blocks:

* the fixed block raises within a few blocks, for either channel;
* the port's Receiver tracks both past that point to the end of the
  capture, every window inside its block;
* its observables equal, exactly (tolerance 0: the same samples reach the
  same arithmetic), those of a run whose blocks start 4 periods earlier
  and end 4 periods later, which never comes near an edge;
* the block's placement keeps channels that lost their lock within the
  block, and when locked channels spread beyond the SPREAD_PERIODS bound
  (a channel whose satellite has set tracks noise) the weaker outermost
  one loses its lock and the run goes on."""
import numpy as np
import pytest
import torch

from gnsslib_tpu_torch import sim
from gnsslib_tpu_torch.constants import DType, FrontendType
from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
from gnsslib_tpu_torch.runtime import receiver as rxmod
from gnsslib_tpu_torch.runtime.config import ChannelConfig, ReceiverConfig
from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker

torch.set_num_threads(2)

F_SF = 4.092e6
F_IF = 1.023e6
NSTEPS = 200                 # periods per block: ~2 samples of drift each
SECONDS = 4.6
B0 = 2 * NSTEPS * 4092       # the stream cursor where the channels start
F_CF = 1.57542e9
# PRN -> the signal's receiver-convention Doppler D (Hz): the tracker's
# carrier offset is -D, so PRN 7's code runs fast (period shorter than
# nominal) and PRN 13's slow
DOPPLER = {7: -4000.0, 13: 4000.0}
EDGE = 3                     # samples inside the fixed block's edges


def _period(D: float) -> float:
    """The code period in samples of a signal with Doppler ``D``."""
    return 1023.0 / (1.023e6 * (1.0 - D / F_CF)) * F_SF


def _block_len(nsamp: int, nwin: int) -> int:
    return rxmod.block_geometry(NSTEPS, nsamp, nwin)["block_len"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The capture, and each PRN's code boundary that the channel starts
    at (an absolute sample): PRN 7 three samples after the fixed block's
    first sample (B0 - nsamp), PRN 13 three samples before the latest
    start whose windows (which begin ``smax`` samples after their
    boundary) fit in that block over the first block's periods."""
    tmp = tmp_path_factory.mktemp("edge")
    trk = Tracker(TrackConfig(corrn=4, corrd=2, corrp=2), [7, 13], [1, 1],
                  F_SF, F_IF, DType.REAL, device="cpu")
    nsamp = trk.n_nom
    starts = {7: B0 - nsamp + EDGE,
              13: B0 + _block_len(nsamp, trk.nwin)
              - int(np.ceil(NSTEPS * _period(DOPPLER[13]))) - trk.smax
              - EDGE}
    chans = []
    for prn, D in DOPPLER.items():
        rate = 1.023e6 * (1.0 - D / F_CF)
        chans.append(sim.SimChannel(
            prn=prn, doppler=D, carr_phase=0.1 * prn,
            code_phase=float(np.mod(-rate * starts[prn] / F_SF, 1023.0))))
    noise = sim.noise_std_for_cn0(1.0, 50.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    path = tmp / "edge.bin"
    with open(path, "wb") as f:
        step = int(F_SF)
        for t0 in range(0, n, step):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=77 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=F_CF, f_sf=F_SF,
                        f_if=F_IF, dtype=DType.REAL)
    return str(path), spec, starts


def _cfg(path, spec, prns=tuple(DOPPLER)):
    return ReceiverConfig(
        channels=[ChannelConfig(prn=p) for p in prns], fends=[spec],
        files=[path], track=TrackConfig(corrn=4, corrd=2, corrp=2),
        outms=400, rinex=False)


class _WideReceiver(rxmod.Receiver):
    """Blocks that start 4 code periods earlier and end 4 later."""

    def _precompile(self):
        self.lead += 4 * self.nsamp
        self.room += 8 * self.nsamp
        self.span = self.room + self.block_len
        self.origin = -self.lead
        super()._precompile()


def _run(cls, capture, noise=None):
    """Both channels started at their edges at B0 (locked and bit-synced,
    so every block runs in the FastTracker), to the end of the capture ->
    (receiver, per block (base, origin, absolute window starts, period
    lengths, ip, qp, dcarr, remcode)).  ``noise``: (PRN absent from the
    capture, its start, its carrier offset), a third channel started
    there, locked and bit-synced, which tracks noise."""
    path, spec, starts = capture
    doppler, starts = dict(DOPPLER), dict(starts)
    if noise is not None:
        prn, starts[prn], dcarr = noise
        doppler[prn] = -dcarr
    rx = cls(_cfg(path, spec, tuple(doppler)), FileFrontend(path, spec),
             device="cpu", nsteps_per_block=NSTEPS)
    rx.base, rx.origin = B0, min(starts.values()) - rx.lead
    for ch in rx.channels:
        D = doppler[ch.cfg.prn]
        rx._start(ch.idx, starts[ch.cfg.prn] - B0, -D, _period(D))
        rx.state = rx.trk.set_bit_sync(rx.state, ch.idx, 0)
        ch.locked = ch.synced = True
    blocks = []
    feed = rx._feed_nav_and_obs

    def record(out, cnt0, base, origin, locked0):
        blocks.append((base, origin, origin + out.loc.astype(np.int64),
                       out.n.copy(), out.ip.copy(), out.qp.copy(),
                       out.dcarr.copy(), out.remcode.copy()))
        feed(out, cnt0, base, origin, locked0)
    rx._feed_nav_and_obs = record
    s = rx.run_seconds()
    rx.close()
    return rx, s, blocks


@pytest.fixture(scope="module")
def runs(capture):
    return {"port": _run(rxmod.Receiver, capture),
            "wide": _run(_WideReceiver, capture)}


def _fixed_block_raise(capture, prn) -> int:
    """The fixed block on the same capture: blocks [base - nsamp, base +
    block_len), the state rebased by the nominal advance.  Returns the
    index of the block whose collect raised (the band correlator's flag),
    or -1."""
    path, spec, starts = capture
    fe = FileFrontend(path, spec)
    trk = Tracker(TrackConfig(corrn=4, corrd=2, corrp=2), [prn], [1],
                  F_SF, F_IF, DType.REAL, device="cpu")
    fast = FastTracker(trk)
    nsamp = trk.n_nom
    blen = _block_len(nsamp, trk.nwin)
    base = B0
    st = trk.start_channels(trk.init_state(), [0],
                            [starts[prn] - (base - nsamp)],
                            [-DOPPLER[prn]])
    st = trk.set_bit_sync(st, 0, 0)
    for k in range(12):
        block = torch.from_numpy(np.ascontiguousarray(
            fe.read(base - nsamp, blen + nsamp)))
        try:
            st, _ = fast.run_block(st, block, NSTEPS)
        except RuntimeError as e:
            assert "outside the sample block" in str(e)
            return k
        st = trk.rebase(st, NSTEPS * nsamp)
        base += NSTEPS * nsamp
    return -1


@pytest.mark.parametrize("prn", [7, 13], ids=["early", "late"])
def test_fixed_block_raises_within_a_few_blocks(capture, prn):
    """The fixed block loses the channel at either edge: the early
    one (+4 kHz of code Doppler) leaves its head, the late one (-4 kHz)
    its tail, within a few 200-period blocks."""
    k = _fixed_block_raise(capture, prn)
    assert 1 <= k <= 8, k


def test_receiver_tracks_past_the_fixed_blocks_edge(capture, runs):
    """The port's blocks follow the channels: both track to the end of the
    capture, far past the block where the fixed design raised, with every
    window inside its block, both channels past the fixed block's edges
    (the early one before its first sample, the late one beyond its
    tail), and the origin a lead before the early channel."""
    rx, s, blocks = runs["port"]
    raised = max(_fixed_block_raise(capture, p) for p in DOPPLER)
    assert len(blocks) >= raised + 10, (len(blocks), raised)
    nsamp, blen = rx.nsamp, rx.block_len
    early = late = False
    for k, (base, origin, starts, n, *_) in enumerate(blocks):
        ends = starts + n
        assert starts.min() >= origin
        assert ends.max() <= origin + rx.span
        # from the second block on (the first was placed by hand) the
        # origin follows the earliest channel: a lead before it, within the
        # estimate's margin (a nominal origin would fall behind it)
        assert k == 0 or abs(starts[0].min() - origin - rx.lead) \
            <= rx.margin
        early |= bool(starts[:, 0].min() < base - nsamp)
        late |= bool(ends[:, 1].max() > base + blen)
    assert early and late
    # the channels keep their code: the early one drifts ahead of the
    # nominal cursor, the late one behind it, at the signals' code Doppler
    first, last = blocks[0][2][0], blocks[-1][2][-1]
    periods = len(blocks) * NSTEPS - 1
    for c, prn in enumerate(DOPPLER):
        drift = (last[c] - first[c]) - periods * nsamp
        want = periods * (_period(DOPPLER[prn]) - nsamp)
        assert abs(drift - want) <= 2, (prn, drift, want)
    assert s["locked"] == list(DOPPLER)


def test_observables_equal_a_run_far_from_the_edge(runs):
    """The same blocks through blocks 4 periods wider on each side:
    every window starts at the same sample and every tap sum, Doppler and
    code phase is the same (tolerance 0)."""
    (_, _, a), (_, _, b) = runs["port"], runs["wide"]
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert ba[0] == bb[0] and ba[1] != bb[1]          # other origins
        for xa, xb in zip(ba[2:], bb[2:]):
            np.testing.assert_array_equal(xa, xb)


def test_lost_channel_is_kept_inside_and_spread_is_bounded(capture):
    """A channel that lost its lock (tracking noise until it is started
    again) and drifted far from the locked one moves by whole code periods
    next to it; of two locked channels wider apart than SPREAD_PERIODS,
    the one with the weaker prompt loses its lock (a ``lol`` event) and
    moves the same way, whichever side it lies on."""
    path, spec, starts = capture
    for weak in (1, 0):
        rx = rxmod.Receiver(_cfg(path, spec), FileFrontend(path, spec),
                            device="cpu", nsteps_per_block=NSTEPS)
        rx.base, rx.origin = B0, B0 - rx.lead
        nsamp = rx.nsamp
        rx._start(0, 0, 4000.0, nsamp)
        rx._start(1, 0, -4000.0, nsamp)
        rx.channels[0].locked = True
        # channel 1 lost its lock and its estimate lies 60 periods late
        rx._pos[1] += 60 * nsamp
        loc0 = rx.state.loc.clone()
        rx._place()
        assert rx.origin == B0 - rx.lead
        assert 0 <= rx._pos[1] - rx._pos[0] < nsamp
        moved = (rx.state.loc - loc0).numpy()
        assert moved[1] - moved[0] == -60 * nsamp
        assert rx.events == []
        # both locked and beyond the bound: the weaker gives way
        rx.channels[1].locked = True
        rx._prompt[:] = 40.0
        rx._prompt[weak] = 4.0
        rx._pos[1] += (rxmod.SPREAD_PERIODS + 2) * nsamp
        keep = 1 - weak
        pos0 = rx._pos.copy()
        rx._place()
        assert [ch.locked for ch in rx.channels] == [weak == 1, weak == 0]
        assert rx.events == [("lol", B0 / F_SF,
                              rx.channels[weak].cfg.prn)]
        assert rx._pos[keep] == pos0[keep]
        assert rx.origin == pos0[keep] - rx.lead
        assert 0 <= rx._pos[weak] - rx._pos[keep] < nsamp


def test_locked_channel_on_noise_past_the_bound_is_reset(capture, runs):
    """A locked channel on an absent PRN (a satellite that has set, with
    RELOCK=0) starts just inside SPREAD_PERIODS of PRN 13 and drifts past
    the bound (its carrier offset runs its code fast, PRN 13's runs slow):
    it loses its lock, the run goes on to the end of the capture, every
    window inside its block, and PRN 7's and 13's observables equal those
    of the run without it (tolerance 0)."""
    path, spec, starts = capture
    nsamp = runs["port"][0].nsamp
    wide = rxmod.SPREAD_PERIODS * nsamp
    start = starts[13] - wide + 40
    rx, s, blocks = _run(rxmod.Receiver, capture,
                         noise=(20, start, 40000.0))
    lol = [e for e in rx.events if e[0] == "lol"]
    assert [e[2] for e in lol] == [20] and B0 / F_SF < lol[0][1] < 1.5
    assert s["locked"] == list(DOPPLER)
    ref = runs["port"][2]
    assert len(blocks) == len(ref)
    for k, (b, r) in enumerate(zip(blocks, ref)):
        starts_, n = b[2], b[3]
        assert starts_.min() >= b[1] and (starts_ + n).max() <= b[1] + \
            rx.span, k
        assert b[0] == r[0]
        for xa, xb in zip(b[2:], r[2:]):
            np.testing.assert_array_equal(xa[:, :2], xb)


def test_snapshot_without_block_origin_resumes(capture, runs):
    """A checkpoint written before blocks followed their channels has no
    origin, positions or live flags, and its state's offsets count from
    one code period before ``base``: restored, the run gives the same
    observables as the run that started there (tolerance 0)."""
    path, spec, starts = capture
    old = rxmod.Receiver(_cfg(path, spec), FileFrontend(path, spec),
                         device="cpu", nsteps_per_block=NSTEPS)
    old.base, old.origin = B0, B0 - old.nsamp
    for ch in old.channels:
        D = DOPPLER[ch.cfg.prn]
        old._start(ch.idx, starts[ch.cfg.prn] - B0, -D, _period(D))
        old.state = old.trk.set_bit_sync(old.state, ch.idx, 0)
        ch.locked = ch.synced = True
    snap = old._snapshot()
    old.close()
    for key in ("origin", "pos", "live"):
        del snap[key]
    rx = rxmod.Receiver(_cfg(path, spec), FileFrontend(path, spec),
                        device="cpu", nsteps_per_block=NSTEPS)
    rx._restore(snap)
    assert rx.origin == B0 - rx.nsamp
    np.testing.assert_array_equal(
        rx._pos, [starts[p] for p in DOPPLER])
    blocks = []
    feed = rx._feed_nav_and_obs

    def record(out, cnt0, base, origin, locked0):
        blocks.append((base, origin + out.loc.astype(np.int64), out.ip.copy(),
                       out.dcarr.copy()))
        feed(out, cnt0, base, origin, locked0)
    rx._feed_nav_and_obs = record
    assert rx.run_seconds()["locked"] == list(DOPPLER)
    rx.close()
    ref = runs["port"][2]
    assert len(blocks) == len(ref)
    for b, r in zip(blocks, ref):
        assert b[0] == r[0]
        for xa, xb in zip(b[1:], (r[2], r[4], r[6])):
            np.testing.assert_array_equal(xa, xb)
