#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gnsslib_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits nonzero):

1. refuse to run without CUDA; print the card, torch and CUDA versions;
2. build the native host kernels (g++; the SBAS Viterbi, CRC-24Q and the
   sample unpackers; the script fails if they do not build) and the
   correlator kernels (csrc/band_taps.cu, window_taps.cu,
   gram_taps.cu, ablation_taps.cu), one nvcc each, all in parallel, and
   print ptxas's registers and spills of the 13-tap instantiations (both
   entry points of K1-K6; K2's banded Gram at the 7 n-tiles of 13 taps
   3 apart; K6's one-tap chain for onetap), K1's 25-tap cluster kernel
   and K2's 11 n-tiles (25 taps), and fail unless K1's 13-tap I/Q
   instantiation has no stack frame and no spill;
3. each kernel vs its plain PyTorch version at the main path's shapes (320
   windows of 16376 samples, 16412-sample replica rows, 13 taps; K2 on
   (320, 128, 128) bf16 rows; K6's four variants at the profiler's 320 x
   16493 windows and 18229-sample rows), real and I/Q input, with
   CUDA-event times of both and the card's bound for the same work.  K1,
   K3-K5 and K6 run as their cluster kernel (K6's on K4's body, its full
   variant checked bit for bit against K4), K2 as its banded-Gram kernel
   on the tensor cores, and each as its v1 kernel, each checked for
   bit-identical repeat launches and timed cold (beyond L2; K1-K5 warm
   too) by launches replayed from a CUDA graph, and cold by eager
   launches; K1 on I/Q input beside the same source capped at 64
   registers, where it spills; K1 also at phase 16's 9-tap shapes (2
   channels: real at 4.092 Msps, I/Q 1 sample apart at 2.048 Msps), and
   past the 25 taps the sources instantiate: at 33, 41 and 65 taps
   (CORRN/CORRD 16/2, 20/2, 32/1; real and I/Q) one launch of its wide
   kernel per super-step, and K2-K5 at 33 taps (real), each a launch per
   group of at most 25 taps (``kernels.tap_plan``).
   Then ``gnsslib_tpu_torch.tools.profile_window`` and ``profile_gram``:
   the window kernel's build steps, cluster sizes and ablations for K3 and
   the f32 instantiation, and K2's, real and I/Q, each checked against the
   plain version and timed by graph replay;
4. synthesize every capture on the card in float64 (sim's signal model,
   noise from torch's seeded generator): the slice's (4 visible
   GPS L1CA PRNs with LNAV bit streams) and the positioning run's (7
   satellites above 15 degrees for a known receiver position, one dark
   in [26, 28) s), 16.368 Msps real int8 at a 4.092 MHz IF, and phase
   11's two front ends: FE1 real (the slice's 4 GPS PRNs and an SBAS
   satellite with MT12 messages), FE2 I/Q at IF 0 (3 GLONASS G1
   satellites, each with its slot in string 4), and phase 15's
   multi-process receiver demo capture (its 4 GPS PRNs, 16 s at 4.092
   Msps), and phase 14's (``receiver_throughput``'s: its 12 satellites,
   C/N0 and int8 scale, 20 s at 16.368 Msps, written where the tools
   read it), and phase 16's: the parity tool's eight scenarios (its
   satellites, rates, lengths, C/N0 and int8 scales; ``ppm`` as RTL-SDR
   u8 I/Q with its +5 ppm LO offset) and tests/test_highdyn.py's 30 Hz/s
   ramp;
5. the block programs (CUDA graphs of a tracking block) replayed against
   the eager loop, bit for bit, for pull-in and the band, pallas, fused
   and xla backends; FastTracker.run_block on the card vs on the CPU from
   one state, with the band, pallas (K3) and fused (K2) backends; then
   the same (pull-in and band) for phase 11's SBAS group (L = 2) and G1
   group (I/Q);
6. the slice: ``Receiver.run_seconds`` from INI files with 32 L1CA
   channels, its pull-in and steady blocks replayed from the graphs
   captured when the receiver was built, checked for acquisition, bit
   sync, TOW decode, the steady state through the band kernel (every K1
   launch counted through the replays), and RINEX pseudoranges against
   the truth;
7. steady-state throughput at bench.py's workload, replayed and eager in
   turns (a record, not a benchmark);
8. the correlator profiler (``gnsslib_tpu_torch.tools.profile_fast``) at
   full width: every backend eager and replayed (as one block graph and as
   a one-super-step graph) and every probe, launching K1-K5 (all through
   their cluster or banded-Gram kernels: no v1 launch), then a short duel
   of the same rows;
9. the kernel profiler (``gnsslib_tpu_torch.tools.profile_kernel``): K6's
   four variants per wrapper call and by graph replay (cluster and v1
   kernels), and 100 chained launches eager and replayed from one CUDA
   graph;
10. the positioning receiver from INI files with 32 L1CA channels and
   SPP, SMOOTH, RAIM, RELOCK, ACQCONFIRM, HOTSTART, RTCM and LOG: fixes
   against the true position, the faded satellite's loss of lock and
   restart, the .pos file, CRC-valid RTCM 1019/1077 frames read by a TCP
   client, track logs; then ``--checkpoint`` at 14 s and ``--resume`` on
   the CLI against an uninterrupted run;
11. the multi-GNSS receiver from INI files on the CLI: 32 GPS L1CA and 3
   SBAS channels on FE1, 14 GLONASS G1 channels on the I/Q FE2, in three
   channel groups (GPS, SBAS at L = 2, G1) with one output hub, RINEX,
   RTCM and SBAS output read by TCP clients: acquisition, bit sync and
   decode of every visible satellite, the G1 slots, G/R/S satellites in
   the RINEX epochs, cross-system pseudoranges against the truth (SBAS's
   within its code period), G and R nav records, CRC-valid RTCM
   1019/1020/1077/1087 and NovAtel RAWSBASFRAME frames; every group's K1
   launches counted through its graph replays (the I/Q group's on a line
   of their own), and the SBAS group's steady wall with the native
   decoder beside the pure-Python decoder's recorded wall;
12. the live receiver: (a) phase 6's capture streamed at 1x real time by
   a pacer process through ``ProcessFrontend`` into ``Receiver.run_live``
   (32 channels, 400-step blocks through the graphs): no overrun, and the
   same events and epochs, bit for bit, as phase 6's file replay; the
   largest lag behind the producer; (b) the CLI with ``TYPE=RTLSDR`` on
   the repo's mock librtlsdr (built with gcc) streaming a 2.046 Msps I/Q
   capture in real time: 32 channels, every visible PRN acquired, locked
   and tracked through K1's I/Q kernel; (c) the block's edges: two
   channels started at the edges of the fixed block (one code period
   before the nominal cursor, nominal rebase) with +/-4 kHz of code
   Doppler, which that design loses
   within a few blocks, tracked by the receiver's replayed graphs to the
   end of the capture with every window inside its block;
13. the diagnostics and the pipeline options: (a) the CLI on phase 6's
   INI with ``--spec --watch-html``: the first second's spectrum (peak
   at the IF) and histogram, the live spectrum monitor (one frame per
   block, on a CUDA stream of its own), the HTML view (taps of every
   visible PRN, ``locked 4/32``), and phase 6's acquisition decisions,
   events and epochs bit for bit; (c) phase 6's receiver with
   ``pipeline=False`` against ``pipeline=True`` bit for bit and at
   pipeline depths 1 and 3 (their own spans and graphs), and phase 11's
   front ends in a MultiReceiver with SPEC for 3 s (one monitor per front
   end, FE2's I/Q spectrum fftshifted); (b) ``--profile`` for 10 s beside
   the same run unprofiled: the trace's size and K1 kernels, and the
   device's busy share over the steady blocks;
14. the receiver tools (``gnsslib_tpu_torch.tools``) in process at full
   width: (a) their capture, as phase 4 wrote it; (e)
   ``scaling_channels`` at C = 32-256 through K1, one launch per
   super-step, ms per super-step by wall and CUDA events (C = 32's gives
   the receiver's device cap), then K1 at C = 256 (2,560 windows) against
   its plain version; (b) ``ttff``
   resident and streamed through the live cache: every milestone, 12
   channels locked and decoded, epochs, the stream run equal to the
   resident one bit for bit; (c) ``receiver_throughput`` pipelined and
   sequential at the tool's 400-step blocks (12 locked, equal
   acquisitions and decodes; the pipelined run's steady median block;
   the sequential run's events and epochs equal, bit for bit, those of
   the pipelined receiver without acquisition and pull-in pipelining;
   run at 400 steps, not 2000, to leave the script time for phase 17);
   (d)
   ``profile_receiver``'s stage table; (f) ``receiver_256ch``: 96 of
   256 channels locked, the graph pool and peak memory; (g)
   ``acq_throughput``: 22,720 bins, PRNs 1-8 acquired; (h)
   ``e2e_receiver_check.run()`` to ``E2E PASS``; (i) ``measure_round``
   with its acq child on the card, the artifact only under a temporary
   directory;
15. the multi-device layer (``gnsslib_tpu_torch.parallel``) on the one
   card: (a) K1 at the shard shapes (8 and 3 channels: 80 and 30
   windows) against its plain version; (b) the sharded engines on 4
   shards of the card (``make_mesh(devices=["cuda:0"] * 4)``, each shard
   with its own block programs) against the unsharded ones from one
   state, at 32 and 13 channels (the uneven split): pull-in, the band
   backend with two blocks in flight collected in order, one block each
   of pallas (K3) and fused (K2), and the acquirer in channel mode (32
   channels) and freq mode (2 channels), with each shard's pool memory;
   (c) phase 6's capture and INI in ``Receiver(mesh=...)`` against the
   unsharded receiver with ``pipeline_acq=False``: decisions, events,
   epochs and RINEX bit for bit (or the first differing field named and
   the fallback bound held), K1 launches = 4 x the unsharded run's steady
   super-steps, counted through the shards' replays; (d) the CLI's
   ``--devices 1`` against phase 6's run, ``--devices 2`` refused with
   ``need 2 devices, have 1`` on a one-card machine (with two cards, run
   and held to phase 6's events and epochs bit for bit); (e) both
   multi-process demos, two processes sharing the card over gloo
   (``MULTIHOST OK``, ``MULTIHOST RECEIVER OK``: both processes' events
   equal each other's and, bit for bit, a single-process receiver's
   (events and epochs), process 0 alone
   writing RINEX, every process's K1 launches); (f)
   ``scaling_efficiency``: channel-samples/s per shard, one process
   against two on the one card, and their ratio (a record: one card
   shows no scaling across cards);
16. the parity tool's half (``gnsslib_tpu_torch.tools.
   parity_vs_reference.run_mine``: the tool's INI files through the
   port's CLI) of its eight scenarios on captures synthesized as the tool
   does (its satellites, rates, lengths, C/N0 and scales; torch's noise)
   and of tests/test_highdyn.py's 30 Hz/s ramp, each held against the
   simulation truth (:func:`phase_parity`), with K1's times at the
   scenarios' 9-tap real and I/Q shapes in phase 3; the reference
   receiver's half needs the reference tree and is not run;
17. the receiver at 33 taps (CORRN/CORRD/CORRP 16/2/6, the DLL's
   +-6-sample spacing of the 13-tap runs): (a) the steady super-step of
   32 channels by CUDA events at 13 and 33 taps (``scaling_channels``);
   (b) phase 16's ``fullenv`` capture (32 GPS channels, 16.368 Msps, 20 s)
   through the CLI at 33 taps, held to phase 16's gates against the
   truth, every steady block one K1 launch per super-step; (c) that run's
   first steady block replayed from its graph against the eager loop, bit
   for bit.

Phases 5-17 each print the graph captures they made (count, seconds
recording and instantiating, pool memory) and their wall time, and a
line before the kernels
line totals them.  The band_taps row's launches are those of phases 6,
11, 12a, 12b, 13, 14, 15 and 16's receiver runs (the main paths: file
replay, multi-GNSS, the live entry point, real and I/Q, the diagnostics
and pipeline modes, the receiver tools, the mesh receiver, the CLI with
``--devices`` and the multi-process receiver demo, the parity tool's
scenarios, and the 33-tap receiver of phase 17).  The
last two lines are a JSON object describing
the kernels and the ``{"ok": true, "device": {...}}`` line.  This script
imports no JAX.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

F_SF = 16.368e6
F_IF = 4.092e6
TOW0 = 352800.0
SECONDS = 28.0          # the third LNAV subframe (nav record) lands ~25 s in
QUANT = 4.0             # int8 scale: 47 dB-Hz noise sigma 12.8 -> ~51 LSB
CN0 = 47.0
# visible PRN -> (delay in samples at t=0, Doppler in Hz)
TRUTH = {3: (1500, 1234.0), 11: (6000, -2345.0), 19: (10500, 3210.0),
         27: (14000, -567.0)}
WORK = os.path.join(ROOT, "build", "gnsslib_tpu_torch", "smoke")
# the card's peaks for a kernel's bound (NVIDIA H100 SXM data sheet, at
# 700 W): device memory rate, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50e6
KERNELS = ("band_taps", "window_taps", "gram_taps", "ablation_taps")
CORR = (6, 3, 6)        # CORRN/CORRD/CORRP of the receiver runs (13 taps)
WIDE_CORR = (16, 2, 6)  # phase 17's receiver and K2-K5's wide check (33 taps)
# the positioning run: a geometry-consistent constellation (the JAX
# package's test_receiver_spp.py construction, 30 candidate orbits so that
# 7 satellites stand above 15 degrees), one satellite dark in a window
# after its ephemeris has been decoded
POS_SECONDS = 34.0
POS_RCV = (-3954844.0, 3354936.0, 3700264.0)     # ECEF (m)
POS_T_OBS = 25.0
POS_FADE = (26.0, 28.0)
POS_FADED = 27                                  # the PRN that goes dark
CKPT_SECONDS = 14.0
# phase 11, the multi-GNSS receiver: FE1 (real, 4.092 MHz IF) carries GPS
# L1CA (the slice's TRUTH) and SBAS, FE2 (I/Q, IF 0, CF 1602 MHz) GLONASS
# G1, both 16.368 Msps int8 on one sample clock.  (MG_TOW - 42) % 30 == 0:
# a GLONASS frame starts 24 s before the capture (its first 12 strings are
# left out) and the next one 6 s into it, so G1 decodes ~16 s in
MG_SECONDS = 30.0
MG_TOW = 352812.0
MG_SBAS_PRNS = (129, 133, 138)
MG_SBAS = {129: (5000, -120.0)}        # visible PRN -> (delay, Doppler)
MG_G1_FCNS = tuple(range(-7, 7))
# visible FDMA number -> (slot in string 4, delay in samples, Doppler)
MG_G1 = {-5: (3, 3000, -1400.0), 1: (13, 8000, 2100.0),
         4: (20, 12500, 600.0)}
# phase 12, the live receiver.  (a) phase 6's capture paced at LIVE_RATE x
# real time by a capture process; (b) the CLI with TYPE=RTLSDR on the
# repo's mock librtlsdr (tools/mock_rtlsdr.c), streaming a 2.046 Msps I/Q
# capture of the slice's satellites in the dongle's u8 format in real time
# (RTL_SECONDS long, the run stopped at RTL_RUN s); (c) two channels
# started at the edges of the fixed block (EDGE samples inside it) with
# +/-4 kHz of code Doppler (the signal's receiver-convention Doppler D:
# PRN 7's code runs fast, PRN 13's slow), from EDGE_B0 on
LIVE_RATE = 1.0
RTL_SF = 2.046e6
RTL_SECONDS = 12.0
RTL_RUN = 10.0
RTL_CORR = (4, 2, 2)    # 9 taps 2 samples (1 chip) apart at 2.046 Msps
RTL_TRUTH = {prn: (d // 8, dop) for prn, (d, dop) in TRUTH.items()}
EDGE_SECONDS = 4.8
EDGE_DOPPLER = {7: -4000.0, 13: 4000.0}
EDGE_NSTEPS = 400
# phase 15's multi-process receiver demo capture: the demo's 4 satellites
# and rates (tools/multihost_receiver_demo.py), 16 s
MH_SECONDS = 16.0
MH_SF, MH_IF = 4.092e6, 1.023e6
# phase 14's capture: receiver_throughput's satellites, 20 s, at its C/N0
# (dB-Hz) and int8 scale
RX_SECONDS = 20.0
RX_LEVELS = (46.0, 16.0)
RX_NSTEPS = 400         # 14c's blocks (400, not 2000: time for phase 17)
# phase 16: the parity tool's scenarios, each synthesized as the tool
# does (its satellites, lengths, rates, C/N0 and int8 scales; torch's
# noise) and run through the tool's run_mine, and tests/test_highdyn.py's
# 30 Hz/s ramp (PRNs 3 and 21, 26 s, 45 dB-Hz, int8 scale 4) through the
# highdyn scenario's INI
PARITY = ("gps", "weak", "ppm", "highdyn", "glo", "sbas", "fullenv",
          "fullenv_glo")
RAMP_RATE = 30.0
RAMP_D0 = {3: 800.0, 21: 2600.0}
RAMP_SECONDS = 26.0
# phase 16's bounds (tests/test_highdyn.py's): the Doppler's fitted slope
# against the truth's (Hz/s), its residual about the fit (Hz), the
# between-satellite pseudorange rate against lambda x the Doppler
# difference (m/s); the SBAS satellite's mean Doppler about the truth (Hz:
# the parity tool's S Doppler bound; about the truth each epoch jitters
# ~1.2 Hz RMS in both packages, the residual bound holds it)
SLOPE_TOL, RESID_TOL, PRATE_TOL, SBAS_D_TOL = 0.6, 3.0, 3.0, 0.5
# the residual bound holds at test_highdyn.py's loop and signal (post-sync
# PLL 10 Hz, 45 dB-Hz); the ppm INI's PLL is 20 Hz wide and the weak
# capture 3 dB fainter, so their Doppler jitters more (the JAX package's
# largest residuals on the same captures: 3.065 and 2.864 Hz)
RESID_SCALE = {"ppm": 2.0, "weak": 2.0 ** 0.5}
# both packages report one SBAS Doppler epoch ~760 Hz off near the sbas
# capture's end (ROADMAP Queue 3): S epochs more than SBAS_SPIKE Hz from
# the median are counted apart, at most SBAS_SPIKES of them
SBAS_SPIKE, SBAS_SPIKES = 5.0, 1
EDGE_B0 = 2 * EDGE_NSTEPS * 16368
EDGE = 3
# the pacer: replays a capture on stdout at ``rate`` x real time (against
# the wall clock, at most one 256 KB chunk ahead) once the file ``go``
# exists, so the receiver is built before the stream starts
PACER = """\
import os, sys, time
path, bps, rate, go = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), \\
    sys.argv[4]
while not os.path.exists(go):
    time.sleep(0.005)
out, sent, t0 = sys.stdout.buffer, 0, time.monotonic()
with open(path, "rb") as f:
    while True:
        d = f.read(1 << 18)
        if not d:
            break
        out.write(d)
        out.flush()
        sent += len(d)
        ahead = t0 + sent / bps / rate - time.monotonic()
        if ahead > 0:
            time.sleep(ahead)
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def pos_geometry():
    """The positioning run's visible satellites (dicts of
    ``sim.geometry_scenario``) and every candidate's ephemeris by PRN."""
    from gnsslib_tpu_torch import sim
    cands, k = [], 0
    for omg0 in (-0.9, -0.55, -0.2, 0.15, 0.5, 0.85):
        for m0 in (-0.8, -0.4, 0.0, 0.4, 0.8):
            k += 1
            cands.append(sim.example_eph(prn=k, week=2200, toe_tow=TOW0,
                                         m0=m0, omg0=omg0))
    geo = sim.geometry_scenario(cands, np.asarray(POS_RCV), TOW0 + POS_T_OBS,
                                TOW0, min_elev_deg=15.0)
    return geo, {e.prn: e for e in cands}


def _sbas_symbols(nmsgs: int, tow: float):
    """SBAS line symbols, 2 ms each: 250-bit messages (1 s each), MT12
    with the time of week every third, preambles cycling 53/9A/C6, rate-1/2
    convolutionally encoded (the JAX package's test_receiver_sbas.py
    stream)."""
    from gnsslib_tpu_torch.nav.sbas import encode_sbas_message
    from gnsslib_tpu_torch.nav.viterbi import conv27_encode
    preambles = [0x53, 0x9A, 0xC6]
    rng = np.random.default_rng(12)
    msgs = []
    for k in range(nmsgs):
        if k % 3 == 0:
            payload = np.zeros(212, np.int64)
            # the framer decodes the oldest of 3 buffered messages and the
            # decoder adds 1 s: the field is the message start + 2
            tow_field = int(tow) + k + 2
            for i in range(20):
                payload[107 - 14 + i] = (tow_field >> (19 - i)) & 1
            wk = (2200 - 1024) & 0x3FF
            for i in range(10):
                payload[127 - 14 + i] = (wk >> (9 - i)) & 1
            msgs.append(encode_sbas_message(12, payload, preambles[k % 3]))
        else:
            msgs.append(encode_sbas_message(63, rng.integers(0, 2, 212),
                                            preambles[k % 3]))
    bits01 = ((1 - np.concatenate(msgs)) // 2).astype(np.int64)
    return np.where(conv27_encode(bits01) == 0, 1, -1).astype(np.int8)


def _multi_signal(kind, f_sf, truth) -> tuple:
    """Phase 11's front end ``kind`` ("fe1": the GPS PRNs of
    ``truth["gps"]`` and the SBAS ones of ``truth["sbas"]``, real; "fe2":
    the G1 satellites of ``truth["g1"]``, I/Q), as :func:`_signal`
    returns it."""
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.constants import (CodeType, DFRQ1_GLO, DType,
                                             FREQ1_GLO)
    from gnsslib_tpu_torch.gtime import gpst2time
    tow, seconds = truth["tow"], truth["seconds"]
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    chans = []
    if kind == "fe1":
        for prn, (d, dop) in truth["gps"].items():
            eph = sim.example_eph(prn=prn, week=2200, toe_tow=tow)
            chans.append(sim.SimChannel(
                prn=prn, doppler=dop, code_phase=-d * 1.023e6 / f_sf,
                carr_phase=0.1 * prn, nav_bits=np.concatenate(
                    [pad, sim.lnav_bit_stream(eph, tow + 6.0, nframes=2)])))
        for prn, (d, dop) in truth["sbas"].items():
            chans.append(sim.SimChannel(
                prn=prn, ctype=CodeType.L1SBAS, doppler=dop,
                code_phase=-d * 1.023e6 / f_sf, carr_phase=0.9, nav_ms=2.0,
                nav_bits=_sbas_symbols(int(seconds) + 2, tow)))
        dtype = DType.REAL
    else:
        for fcn, (slot, d, dop) in truth["g1"].items():
            # the frame before the capture's, its first 24 s left out
            sym = sim.g1_symbol_stream(gpst2time(2200, tow - 24.0),
                                       nframes=2, iode=44, slot=slot)[2400:]
            chans.append(sim.SimChannel(
                prn=fcn, ctype=CodeType.G1, doppler=dop,
                code_phase=-d * 0.511e6 / f_sf, carr_phase=0.3 + 0.1 * slot,
                nav_bits=sym, nav_ms=10.0,
                f_cf=FREQ1_GLO + fcn * DFRQ1_GLO, foffset=fcn * DFRQ1_GLO))
        dtype = DType.IQ
    return chans, dtype, 3000 if kind == "fe1" else 4000, "int8"


def multi_truth() -> dict:
    """Phase 11's satellites and timing (module constants), for the
    synthesis workers."""
    return dict(gps=TRUTH, sbas=MG_SBAS, g1=MG_G1, tow=MG_TOW,
                seconds=MG_SECONDS)


def _signal(kind, t0, f_sf, truth) -> tuple:
    """The satellites of capture ``kind`` ("slice", "pos", "fe1", "fe2",
    "rtl" or "edge") in its chunk from sample ``t0`` (the positioning
    capture's faded satellite is left out of its dark seconds): (their
    ``sim.SimChannel`` list, the DType, the base of the chunk's noise
    seed, the sample format: "int8" or "rtlsdr")."""
    if kind in ("fe1", "fe2"):
        return _multi_signal(kind, f_sf, truth)
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.constants import DType
    if kind == "mh":
        # the multi-process receiver demo's satellites
        from gnsslib_tpu_torch.tools import multihost_receiver_demo as mh
        return mh.satellites(), DType.REAL, 7000, "int8"
    if kind == "rx":
        from gnsslib_tpu_torch.tools import receiver_throughput as rxt
        return rxt._chans(RX_SECONDS), DType.REAL, 1000, "int8"
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    if kind == "edge":
        # truth: PRN -> (the sample where a code period starts, Doppler)
        chans = []
        for prn, (start, dop) in truth.items():
            rate = 1.023e6 * (1.0 - dop / 1.57542e9)
            chans.append(sim.SimChannel(
                prn=prn, doppler=dop, carr_phase=0.1 * prn,
                code_phase=float(np.mod(-rate * start / f_sf, 1023.0))))
        return chans, DType.REAL, 6000, "int8"
    if kind == "rtl":
        chans = [sim.SimChannel(
            prn=prn, doppler=dop, code_phase=-d * 1.023e6 / f_sf,
            carr_phase=0.1 * prn, nav_bits=np.concatenate(
                [pad, sim.lnav_bit_stream(
                    sim.example_eph(prn=prn, week=2200, toe_tow=TOW0),
                    TOW0 + 6.0, nframes=1)]))
            for prn, (d, dop) in truth.items()]
        return chans, DType.IQ, 5000, "rtlsdr"
    if kind == "pos":
        geo, ephs = pos_geometry()
        dark = POS_FADE[0] <= t0 / f_sf < POS_FADE[1]
        chans = [sim.SimChannel(
            prn=g["prn"], doppler=g["doppler"], code_phase=g["code_phase"],
            carr_phase=0.11 * g["prn"], nav_bits=np.concatenate(
                [pad, sim.lnav_bit_stream(ephs[g["prn"]], TOW0 + 6.0,
                                          nframes=2)]))
            for g in geo if not (dark and g["prn"] == POS_FADED)]
        return chans, DType.REAL, 2000, "int8"
    chans = []
    for prn, (d, dop) in truth.items():
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
        # 300 pad bits (6 s) ending +1,+1 so word-1 parity sees D29*=D30*=0
        chans.append(sim.SimChannel(
            prn=prn, doppler=dop, code_phase=-d * 1.023e6 / f_sf,
            carr_phase=0.1 * prn, nav_bits=np.concatenate([pad, frames])))
    return chans, DType.REAL, 1000, "int8"


def parity_signal(kind: str) -> tuple:
    """Phase 16's capture ``kind`` ("par_<scenario>" or "ramp"): (its
    satellites, seconds, f_sf, f_if, I/Q, noise sigma, int8 scale, sample
    format, the base of the chunks' noise seeds), as the parity tool
    synthesizes the scenario (``ramp``: tests/test_highdyn.py's
    capture)."""
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.constants import DType
    from gnsslib_tpu_torch.tools import parity_vs_reference as pvr
    if kind == "ramp":
        chans = []
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        for prn, d in ((3, 300), (21, 1300)):
            eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
            frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
            chans.append(sim.SimChannel(
                prn=prn, doppler=RAMP_D0[prn], doppler_rate=RAMP_RATE,
                code_phase=-d * 1.023e6 / 4.092e6, carr_phase=0.1 * prn,
                nav_bits=np.concatenate([pad, frames])))
        noise = sim.noise_std_for_cn0(1.0, 45.0, 4.092e6, DType.REAL)
        return (chans, RAMP_SECONDS, 4.092e6, 1.023e6, False, noise, 4.0,
                "int8", 9000)
    scen = kind[len("par_"):]
    if scen.startswith("fullenv"):
        glo = scen == "fullenv_glo"
        noise, scale = pvr.fullenv_levels(glo)
        return (pvr._fullenv_chans(glo), 30.0 if glo else 20.0, 16.368e6,
                4.092e6, False, noise, scale, "int8", 5000)
    if scen in ("glo", "sbas"):
        chans, seconds, seed = ((pvr.glo_channels(), 40.0, 4000)
                                if scen == "glo"
                                else (pvr.sbas_channels(), 30.0, 8000))
        noise = sim.noise_std_for_cn0(1.0, 47.0, 4.092e6, DType.REAL)
        return (chans, seconds, 4.092e6, 1.023e6, False, noise, 16.0,
                "int8", seed)
    knobs = pvr.SCENARIOS[scen]["knobs"]
    chans, f_sf, f_if, dtype, noise, scale = pvr.stress_channels(**knobs)
    return (chans, 32.0, f_sf, f_if, dtype == DType.IQ, noise, scale,
            "rtlsdr" if knobs.get("rtl") else "int8", 1000)


def _synthesize(dev, chans, f_sf: float, f_if: float, iq: bool, n: int,
                noise_std: float, seed: int, t0: int):
    """Samples [t0, t0+n) of ``chans`` in float64 on ``dev``: the signal
    model of ``sim.synthesize`` (code and carrier Doppler, nav bits,
    FDMA offsets; (n,) real or (n, 2) I/Q), with the noise drawn by
    torch's generator seeded with ``seed``."""
    import torch
    from gnsslib_tpu_torch import codes
    f64 = dict(dtype=torch.float64, device=dev)
    t = (t0 + torch.arange(n, **f64)) / f_sf
    out = torch.zeros((n, 2) if iq else n, **f64)
    for ch in chans:
        code, crate = codes.gencode(ch.prn, ch.ctype)
        dphi = ch.doppler * t + 0.5 * ch.doppler_rate * t * t
        chips = ch.code_phase + crate * (t - dphi / ch.f_cf)
        c = torch.as_tensor(np.asarray(code, np.float64), device=dev)[
            torch.remainder(torch.floor(chips).long(), len(code))]
        if ch.nav_bits is not None:
            bits = torch.as_tensor(np.asarray(ch.nav_bits, np.float64),
                                   device=dev)
            k = torch.floor(chips / (crate * ch.nav_ms * 1e-3)).long()
            c = c * bits[torch.remainder(k, len(bits))]
        phase = 2.0 * math.pi * ((f_if + ch.foffset) * t - dphi
                                 + ch.carr_phase)
        a = ch.amplitude * c
        if iq:
            out[:, 0] += a * torch.cos(phase)
            out[:, 1] -= a * torch.sin(phase)
        else:
            out += a * torch.cos(phase)
    if noise_std > 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out += noise_std * torch.randn(out.shape, generator=gen, **f64)
    return out


def _quantize(x, fmt: str, scale: float = QUANT,
              rtl_scale: float = 8.0) -> bytes:
    """``sim.quantize_int8(x, scale)`` ("int8") or
    ``sim.quantize_rtlsdr(x, rtl_scale)`` ("rtlsdr") of a tensor, as
    bytes."""
    import torch
    if fmt == "int8":
        q = torch.clamp(torch.round(x * scale), -128, 127).to(torch.int8)
    else:
        q = torch.clamp(torch.round(x * rtl_scale), -127, 127)
        q = torch.where(q >= 0, q + 128, q + 127).to(torch.uint8)
    return q.reshape(-1).cpu().numpy().tobytes()


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device milliseconds per ``fn()``: CUDA events around ``reps``
    back-to-back calls (so host launch latency overlaps the device work),
    divided by ``reps``; the median of ``rounds`` such runs after a
    warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def cold_ms(fn_k, ncopy: int, reps: int = 60, rounds: int = 5) -> float:
    """Like :func:`cuda_ms` for ``fn_k(k)``, whose call k reads input copy
    ``k % ncopy``: with the copies together beyond the L2 cache, each
    launch reads its inputs from device memory, as the tracker's does."""
    import torch
    fn_k(0)
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for r in range(reps):
            fn_k(r % ncopy)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def copies_for(nbytes: int) -> int:
    """Input copies whose total is at least twice the L2 cache."""
    return max(2, int(np.ceil(2 * L2_BYTES / nbytes)))


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card takes to move
    ``nbytes`` and do ``flops`` f32 operations, the larger of the two."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def union_len(starts, lens) -> int:
    """Samples in the union of the intervals [start, start + len)."""
    total, end = 0, None
    for a, b in sorted(zip(starts, np.asarray(starts) + np.asarray(lens))):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return int(total)


# --------------------------------------------------------------------- #
def hold_k1(dev, iq: bool, tag: str, **geometry):
    """K1 through the wrapper (one kernel launch, no v1 or plain) and by
    launch of the cluster and v1 kernels, held against ``band_taps_plain``
    at ``pb.tolerance``, each kernel's two launches bit-identical, on
    :func:`profile_band.inputs` at ``geometry`` (phase 3's by default).
    Returns (trk, host, args, plain taps, tolerance, {launch: max error},
    {name: launch function})."""
    import torch
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.ops.kernels import progression
    from gnsslib_tpu_torch.tools import profile_band as pb
    trk, host, args = pb.inputs(dev, iq, **geometry)
    B = host[1].shape[0]
    offsets, smax = trk.offsets, trk.smax
    kind = "iq" if iq else "real"
    bt.COUNTS.reset()
    zk, okk = bt.band_taps(*args, offsets, smax)
    zp, okp = bt.band_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    if (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain) != (1, 0, 0):
        raise AssertionError(f"[{tag}] band_taps ({kind}) wrapper: launches "
                             f"{bt.COUNTS.kernel}, v1 {bt.COUNTS.v1}, plain "
                             f"{bt.COUNTS.plain}")
    tol = pb.tolerance(host, trk.nwin)       # 1e-5 of the window L1 norm
    # the launches compared: the cluster kernel and the v1 kernel
    runs = {"kernel": bt.launch, "v1": bt.launch_v1}

    def once(fn):
        z = torch.empty_like(zp)
        ok = torch.ones(1, dtype=torch.int32, device=dev)
        fn(*args, offsets, smax, z, ok)
        return z, ok

    errs = {"wrapper": float((zk - zp).abs().max())}
    bad = [] if bool(okk) and bool(okp) else ["ok flags"]
    for name, fn in runs.items():
        z, ok = once(fn)
        torch.cuda.synchronize()
        errs[name] = float((z - zp).abs().max())
        if not bool(ok[0]):
            bad.append(f"{name} ok flag")
    bad += [f"{k} {e}" for k, e in errs.items() if not e <= tol]
    # determinism: two launches of each kernel agree bit for bit
    for name in ("kernel", "v1"):
        z1, _ = once(runs[name])
        z2, _ = once(runs[name])
        if not torch.equal(z1.view(torch.int32), z2.view(torch.int32)):
            bad.append(f"{name} repeat launches differ")
    log(f"[{tag}] band_taps {kind:4s} B={B} nwin={trk.nwin} next={trk.next} "
        f"taps={len(offsets)} d={progression(tuple(map(int, offsets)))} "
        f"at {trk.f_sf / 1e6:.3f} Msps: max_abs_err "
        + ", ".join(f"{k} {e:.4g}" for k, e in errs.items())
        + f" (tol {tol:.4g}, max|taps| {float(zp.abs().max()):.4g}); "
        f"repeat launches bit-identical: {'no' if bad else 'yes'}")
    if bad:
        raise AssertionError(f"[{tag}] band_taps ({kind}) vs plain: {bad}")
    return trk, host, args, zp, tol, errs, runs


def phase_kernel(dev, iq: bool, tag: str = "3", **geometry):
    """K1 at the 32-channel L1CA super-step's shapes (or at
    :func:`profile_band.inputs`'s ``geometry``): the cluster kernel
    (through the wrapper and by launch) and the v1 kernel against the
    plain version, two launches bit-identical (:func:`hold_k1`), and warm
    and cold (beyond L2) times of both.  Importable: after
    ``cuda_build.build_all(("band_taps",))`` it is the kernel-only loop;
    ``python -m gnsslib_tpu_torch.tools.profile_band`` times the cluster
    kernel's build steps and cluster sizes."""
    import torch
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.tools import profile_band as pb
    trk, host, args, zp, _, errs, runs = hold_k1(dev, iq, tag, **geometry)
    block, rc, wstart, n, rem, ftot, act = host
    B = rc.shape[0]
    offsets, smax = trk.offsets, trk.smax
    kind = "iq" if iq else "real"

    out = torch.empty_like(zp)
    ok = torch.ones(1, dtype=torch.int32, device=dev)
    call_ms = cuda_ms(lambda: bt.band_taps(*args, offsets, smax), 50)
    plain_ms = cuda_ms(lambda: bt.band_taps_plain(*args, offsets, smax), 5)
    # the bound: the block samples the active windows cover (their shared
    # band, read once), their replica rows, the scalars and the taps out
    T = len(offsets)
    nv = np.minimum(n, trk.nwin)[act]
    comp = 2 if iq else 1
    nbytes = (union_len(wstart[act], nv) * 4 * comp + len(nv) * trk.next
              + B * 17 + B * 2 * T * 4)
    flops = float(nv.sum()) * (4 * T + (6 if iq else 2))
    bms, by = bound(nbytes, flops)
    copies = [[a.clone() for a in args] for _ in range(copies_for(nbytes))]

    def on_copy(fn):
        return lambda c: fn(*copies[c], offsets, smax, out, ok)

    # device time: launches replayed from a CUDA graph, so that the host's
    # time per eager launch (Python and ctypes) cannot hide the kernel's
    cold = {k: pb.graph_ms(on_copy(fn), len(copies))
            for k, fn in runs.items()}
    warm = {k: pb.graph_ms(lambda c, fn=fn: fn(*args, offsets, smax, out,
                                                ok), 1)
            for k, fn in runs.items()}
    eager = {k: cold_ms(on_copy(fn), len(copies)) for k, fn in runs.items()}
    spill_ms = None
    if iq and not geometry:
        # the same source with I/Q held to real input's 64 registers, where
        # its 13-tap instantiation spills (the build before the repair)
        fn64 = pb.launcher(pb.build(["iq64"])["iq64"], offsets, smax, out,
                           ok)
        spill_ms = pb.graph_ms(lambda c: fn64(copies[c]), len(copies))
        log(f"[3] band_taps iq: {card_line()}; cluster kernel "
            f"{cold['kernel']:.4f} ms (80 registers, no spill: phase 2); "
            f"the same source capped at 64 registers "
            f"({pb.usage_text(pb.usage(pb._LIBS['iq64'][1], True))}) "
            f"{spill_ms:.4f} ms in this run; 0.0220 ms in the records "
            f"before the repair (PERF.md)")
    log(f"[{tag}] band_taps {kind:4s} T={T}: {card_line()}; cluster "
        f"kernel S="
        f"{bt.ctas_per_window()} CTAs per window, J="
        f"{bt.samples_per_thread()} samples per thread: cold "
        f"{cold['kernel']:.4f} ms/launch, warm {warm['kernel']:.4f} ms; v1 kernel "
        f"cold {cold['v1']:.4f} ms, warm {warm['v1']:.4f} ms "
        f"(device time: launches replayed from one CUDA graph; "
        f"cold: inputs rotated over {len(copies)} copies, beyond L2); eager "
        f"back-to-back launches, cold: kernel {eager['kernel']:.4f} ms, v1 "
        f"{eager['v1']:.4f} ms; wrapper call {call_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; bound {bms:.4f} ms by {by} ({nbytes / 1e6:.2f} "
        f"MB, {flops / 1e6:.1f} MFLOP)")
    return dict(err=max(errs.values()), ms=cold["kernel"],
                warm_ms=warm["kernel"], v1_ms=cold["v1"],
                v1_warm_ms=warm["v1"], eager_ms=eager["kernel"],
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                timing="graph_replay", spill64_ms=spill_ms)


def phase_window_kernels(dev, iq: bool, corr=CORR, tag: str = "3") -> dict:
    """K5, K4 (f32) and K3 (bf16 windows, int8 rows) at the 32-channel L1CA
    super-step's shapes (tap geometry ``corr``): each wrapper (one
    cluster-kernel launch per group of ``kernels.tap_plan``: one up to 25
    taps; no v1, no plain), the cluster kernel and the v1 kernel against
    the plain version, two launches of each bit-identical, and cold
    (beyond L2) and warm times of both by graph replay, cold eager
    beside.  Importable:
    after ``cuda_build.build_all(("window_taps",))`` it is the kernel-only
    loop; ``python -m gnsslib_tpu_torch.tools.profile_window`` times the
    cluster kernel's build steps, cluster sizes and ablations."""
    import torch
    from gnsslib_tpu_torch.ops import window_taps as wt
    from gnsslib_tpu_torch.ops.kernels import tap_groups
    from gnsslib_tpu_torch.tools.profile_band import graph_ms
    from gnsslib_tpu_torch.tools.profile_window import inputs, tolerance
    kind = "iq" if iq else "real"
    res = {}
    for name, k, counts in (("correlate_windows", 0, wt.COUNTS5),
                            ("correlate_windows8", 0, wt.COUNTS8),
                            ("correlate_windows16", 1, wt.COUNTS16)):
        fn = getattr(wt, name)
        trk, l1, host, args = inputs(dev, "bf16" if k else "f32", iq,
                                     corr=corr)
        B, T, smax, offsets = len(host[4]), len(trk.offsets), trk.smax, \
            trk.offsets
        groups = len(tap_groups(T))
        counts.reset()
        zk = fn(*args, offsets, smax)
        zp = wt.window_taps_plain(*args, offsets, smax)
        torch.cuda.synchronize()
        if (counts.kernel, counts.v1, counts.plain) != (groups, 0, 0):
            raise AssertionError(f"{name} ({kind}) wrapper: launches "
                                 f"{counts.kernel}, v1 {counts.v1}, plain "
                                 f"{counts.plain}")
        # f32: summation order and the carrier's ulps, 1e-5 of the
        # window's L1 norm (as K1); bf16 (K3): an ulp of the carrier can
        # also flip a mixed sample's bf16 rounding, each flip moving a tap
        # by at most 2^-7 |x_i|: 1e-4
        tol = tolerance("bf16" if k else "f32", l1)
        runs = {"kernel": wt.launch, "v1": wt.launch_v1}

        def once(launch, inputs):
            z = torch.empty_like(zp)
            launch(k, *inputs, offsets, smax, z)
            return z

        errs = {"wrapper": float((zk - zp).abs().max())}
        bad = []
        for run, launch in runs.items():
            z1 = once(launch, args)
            z2 = once(launch, args)
            torch.cuda.synchronize()
            errs[run] = float((z1 - zp).abs().max())
            if not torch.equal(z1.view(torch.int32), z2.view(torch.int32)):
                bad.append(f"{run} repeat launches differ")
        bad += [f"{r} {e}" for r, e in errs.items() if not e <= tol]
        log(f"[{tag}] {name} {kind:4s} B={B} nwin={trk.nwin} next="
            f"{trk.next} taps={T} ({groups} launch{'es' * (groups > 1)}): "
            f"max_abs_err "
            + ", ".join(f"{r} {e:.4g}" for r, e in errs.items())
            + f" (tol {tol:.4g}, max|taps| {float(zp.abs().max()):.4g}); "
            f"repeat launches bit-identical: {'no' if bad else 'yes'}")
        if bad:
            raise AssertionError(f"{name} ({kind}) vs plain: {bad}")

        out = torch.empty_like(zk)
        comp = 2 if iq else 1
        nv = np.minimum(host[4], trk.nwin)
        wb, rb = args[0].element_size() * comp, args[1].element_size()
        # the bound: each window's valid samples and the replica values its
        # taps read, the scalars, the taps out
        nbytes = (float(nv.sum()) * wb + float((nv + 2 * smax).sum()) * rb
                  + B * 12 + B * 2 * T * 4)
        flops = float(nv.sum()) * (4 * T + (6 if iq else 2))
        bms, by = bound(nbytes, flops)
        copies = [[a.clone() for a in args]
                  for _ in range(copies_for(nbytes))]

        def on_copy(launch):
            return lambda c: launch(k, *copies[c], offsets, smax, out)

        # device time: launches replayed from a CUDA graph
        cold = {r: graph_ms(on_copy(launch), len(copies))
                for r, launch in runs.items()}
        warm = {r: graph_ms(lambda c, launch=launch: launch(
                    k, *args, offsets, smax, out), 1)
                for r, launch in runs.items()}
        eager = {r: cold_ms(on_copy(launch), len(copies))
                 for r, launch in runs.items()}
        call_ms = cuda_ms(lambda: fn(*args, offsets, smax), 50)
        plain_ms = cuda_ms(lambda: wt.window_taps_plain(
            *args, offsets, smax), 5)
        log(f"[{tag}] {name} {kind:4s}: {card_line()}; cluster kernel S="
            f"{wt.ctas_per_window()} CTAs per window, J="
            f"{wt.samples_per_thread()} samples per chain: cold "
            f"{cold['kernel']:.4f} ms per call of its {groups} launch"
            f"{'es' * (groups > 1)}, warm {warm['kernel']:.4f} ms; "
            f"v1 kernel cold {cold['v1']:.4f} ms, warm {warm['v1']:.4f} ms "
            f"(device time: launches replayed from one CUDA graph; cold: "
            f"inputs rotated over {len(copies)} copies, beyond L2); eager "
            f"back-to-back launches, cold: kernel {eager['kernel']:.4f} ms, "
            f"v1 {eager['v1']:.4f} ms; wrapper call {call_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bms:.4f} ms by {by} "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
        res[name] = dict(err=max(errs.values()), ms=cold["kernel"],
                         warm_ms=warm["kernel"], v1_ms=cold["v1"],
                         v1_warm_ms=warm["v1"], eager_ms=eager["kernel"],
                         v1_eager_ms=eager["v1"], plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, timing="graph_replay")
    return res


def phase_window_profiler(dev) -> dict:
    """``tools/profile_window.py``: K3's and the f32 instantiation's build
    steps, cluster sizes and ablations, real and I/Q, each variant that
    computes the function held against the plain version, then timed by
    graph replay; returns {(kind, iq): {variant: record}}."""
    from gnsslib_tpu_torch.tools import profile_window
    out = {}
    for kind in ("bf16", "f32"):
        for iq in (False, True):
            out[kind, iq] = profile_window.profile(
                kind, iq, log=lambda m: log(f"[3] {m}"))
    return out


def phase_gram_kernel(dev, iq: bool, corr=CORR, tag: str = "3") -> dict:
    """K2 at the 32-channel L1CA super-step's shapes ((320, 128, 128) bf16
    rows fetched and masked as the fused backend fetches them): the
    wrapper (one banded-Gram launch, no v1, no plain), the banded-Gram
    kernel and the v1 kernel against the plain version, two launches of
    each bit-identical, and cold (beyond L2) and warm times of both by
    graph replay, cold eager beside; at ``corr`` past 25 taps one launch
    per group of ``kernels.tap_plan``.  Importable: after
    ``cuda_build.build_all(("gram_taps",))`` it is the kernel-only loop;
    ``python -m gnsslib_tpu_torch.tools.profile_gram`` times the kernel's
    build steps, cluster sizes and ablations."""
    import torch
    from gnsslib_tpu_torch.ops import gram_taps as gt
    from gnsslib_tpu_torch.ops.kernels import tap_groups
    from gnsslib_tpu_torch.tools.profile_band import graph_ms
    from gnsslib_tpu_torch.tools.profile_gram import inputs, tolerance
    trk, l1, n, args = inputs(dev, iq, corr=corr)
    B, T, smax, offsets = args[0].shape[0], len(trk.offsets), trk.smax, \
        trk.offsets
    groups = len(tap_groups(T))
    kind = "iq" if iq else "real"
    gt.COUNTS.reset()
    zk = gt.gram_taps(*args, offsets, smax)
    zp = gt.gram_taps_plain(*args, offsets, smax)
    torch.cuda.synchronize()
    if (gt.COUNTS.kernel, gt.COUNTS.v1, gt.COUNTS.plain) != (groups, 0, 0):
        raise AssertionError(f"gram_taps ({kind}) wrapper: launches "
                             f"{gt.COUNTS.kernel}, v1 {gt.COUNTS.v1}, plain "
                             f"{gt.COUNTS.plain}")
    # the mixed samples keep the plain version's bf16 values: summation
    # order only, within K3's 1e-4 of the window's L1 norm
    tol = tolerance(l1)
    runs = {"kernel": gt.launch, "v1": gt.launch_v1}

    def once(launch, inputs):
        z = torch.empty_like(zp)
        launch(*inputs, offsets, smax, z)
        return z

    errs = {"wrapper": float((zk - zp).abs().max())}
    bad = []
    for run, launch in runs.items():
        z1 = once(launch, args)
        z2 = once(launch, args)
        torch.cuda.synchronize()
        errs[run] = float((z1 - zp).abs().max())
        if not torch.equal(z1.view(torch.int32), z2.view(torch.int32)):
            bad.append(f"{run} repeat launches differ")
    bad += [f"{r} {e}" for r, e in errs.items() if not e <= tol]
    K = args[0].shape[1]
    log(f"[{tag}] gram_taps {kind:4s} B={B} rows={K}x128 next={trk.next} "
        f"taps={T} ({groups} launch{'es' * (groups > 1)}): max_abs_err "
        + ", ".join(f"{r} {e:.4g}" for r, e in errs.items())
        + f" (tol {tol:.4g}, max|taps| {float(zp.abs().max()):.4g}); "
        f"repeat launches bit-identical: {'no' if bad else 'yes'}")
    if bad:
        raise AssertionError(f"gram_taps ({kind}) vs plain: {bad}")

    out = torch.empty_like(zk)
    # the bound: the rows and the replica bytes they read, the scalars,
    # the taps out; the direct tap sums' f32 operations over the valid
    # samples (the same work whatever implements it, as for the v1 kernel)
    nbytes = (B * K * 128 * 2 * (2 if iq else 1)
              + B * min(trk.next, K * 128 + 2 * smax) + B * 8
              + B * 2 * T * 4)
    flops = float(np.minimum(n, trk.nwin).sum()) * (4 * T + (12 if iq else 8))
    bms, by = bound(nbytes, flops)
    copies = [[None if a is None else a.clone() for a in args]
              for _ in range(copies_for(nbytes))]

    def on_copy(launch):
        return lambda c: launch(*copies[c], offsets, smax, out)

    # device time: launches replayed from a CUDA graph
    cold = {r: graph_ms(on_copy(launch), len(copies))
            for r, launch in runs.items()}
    warm = {r: graph_ms(lambda c, launch=launch: launch(
                *args, offsets, smax, out), 1)
            for r, launch in runs.items()}
    eager = {r: cold_ms(on_copy(launch), len(copies))
             for r, launch in runs.items()}
    call_ms = cuda_ms(lambda: gt.gram_taps(*args, offsets, smax), 50)
    plain_ms = cuda_ms(lambda: gt.gram_taps_plain(*args, offsets, smax), 5)
    log(f"[{tag}] gram_taps {kind:4s}: {card_line()}; banded-Gram kernel "
        f"S={gt.ctas_per_window()} CTAs per window, "
        f"{len(gt.tile_plan(K, smax)[0])} n-tiles per m-tile: cold "
        f"{cold['kernel']:.4f} ms per call of its {groups} launch"
        f"{'es' * (groups > 1)}, warm {warm['kernel']:.4f} ms; "
        f"v1 kernel cold {cold['v1']:.4f} ms, warm {warm['v1']:.4f} ms "
        f"(device time: launches replayed from one CUDA graph; cold: "
        f"inputs rotated over {len(copies)} copies, beyond L2); eager "
        f"back-to-back launches, cold: kernel {eager['kernel']:.4f} ms, "
        f"v1 {eager['v1']:.4f} ms; wrapper call {call_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; bound {bms:.4f} ms by {by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
    return dict(err=max(errs.values()), ms=cold["kernel"],
                warm_ms=warm["kernel"], v1_ms=cold["v1"],
                v1_warm_ms=warm["v1"], eager_ms=eager["kernel"],
                v1_eager_ms=eager["v1"], plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, timing="graph_replay")


def phase_gram_profiler(dev) -> dict:
    """``tools/profile_gram.py``: K2's build steps, cluster sizes and
    ablations, real and I/Q, each variant that computes the function held
    against the plain version, then timed by graph replay; returns
    {iq: {variant: record}}."""
    from gnsslib_tpu_torch.tools import profile_gram
    return {iq: profile_gram.profile(iq, log=lambda m: log(f"[3] {m}"))
            for iq in (False, True)}


def phase_ablation_kernel(dev) -> dict:
    """K6's four variants at the kernel profiler's shapes (B = 320, nwin =
    16493, W = 18229, 13 taps at range(-18, 19, 3)): each wrapper (one
    cluster-kernel launch, no v1, no plain), the cluster kernel and the v1
    kernel against the plain version, ``full`` against correlate_windows8
    (K4) at tap_offsets(6, 3) bit for bit, two launches and a graph replay
    of each kernel bit-identical, and cold (beyond L2) times of both by
    graph replay, eager beside.  Importable: after
    ``cuda_build.build_all(("ablation_taps", "window_taps"))`` it is the
    kernel-only loop."""
    import torch
    from gnsslib_tpu_torch.ops import ablation_taps as ab
    from gnsslib_tpu_torch.ops import window_taps as wt
    from gnsslib_tpu_torch.ops.correlator import tap_offsets
    from gnsslib_tpu_torch.tools import profile_kernel as pk
    from gnsslib_tpu_torch.tools.profile_band import graph_ms
    args = pk.inputs(dev)
    win, rc, rem, ftot, n = args
    B, nwin = win.shape
    offs, smax, T = pk.OFFSETS, pk.SMAX, len(pk.OFFSETS)
    nv = np.minimum(np.ceil(n.cpu().numpy()), nwin).astype(np.int64)
    l1 = win.abs().sum(dim=1)
    runs = {"kernel": ab.launch, "v1": ab.launch_v1}

    def bits(z):
        return z.view(torch.int32)

    # full is K4's f32 instantiation: its taps at K6's ascending offsets
    # are K4's at tap_offsets(6, 3), columns permuted, bit for bit (K4's
    # int bound ceil(n) keeps the same samples, i < n)
    k4_offs = tuple(int(o) for o in tap_offsets(6, 3))
    z4 = wt.correlate_windows8(win, rc, rem, ftot,
                               torch.ceil(n).to(torch.int32), k4_offs, smax)
    cols = [2 * k4_offs.index(o) + c for o in offs for c in (0, 1)]
    z6 = ab.ablation_taps(*args, offs, smax, "full")
    torch.cuda.synchronize()
    same_k4 = torch.equal(bits(z6), bits(z4[:, cols].contiguous()))
    log(f"[3] ablation_taps[full] vs correlate_windows8 at "
        f"tap_offsets(6, 3), columns permuted: bit-identical "
        f"{'yes' if same_k4 else 'no'}")
    if not same_k4:
        raise AssertionError("ablation_taps[full] differs from "
                             "correlate_windows8: "
                             f"{float((z6 - z4[:, cols]).abs().max())}")
    res = {}
    for v in ab.VARIANTS:
        counts = ab.COUNTS[v]
        counts.reset()
        zk = ab.ablation_taps(*args, offs, smax, v)
        zp = ab.PLAIN[v](*args, offs, smax)
        torch.cuda.synchronize()
        if (counts.kernel, counts.v1, counts.plain) != (1, 0, 0):
            raise AssertionError(f"ablation_taps[{v}] wrapper: launches "
                                 f"{counts.kernel}, v1 {counts.v1}, plain "
                                 f"{counts.plain}")
        # f32 both: summation order and the carrier's rounding, 1e-5 of
        # each window's L1 norm (as K1, K4, K5)
        zs = {"wrapper": zk}
        bad = []
        for run, launch in runs.items():
            z1, z2 = torch.empty_like(zp), torch.empty_like(zp)
            launch(v, *args, offs, smax, z1)
            launch(v, *args, offs, smax, z2)
            torch.cuda.synchronize()
            zs[run] = z1
            if not torch.equal(bits(z1), bits(z2)):
                bad.append(f"{run} repeat launches differ")
            # one launch captured in a CUDA graph, replayed
            zg = torch.zeros_like(zp)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                launch(v, *args, offs, smax, zg)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(bits(zg), bits(z1)):
                bad.append(f"{run} graph replay differs")
        errw = {r: (z - zp).abs().max(dim=1).values for r, z in zs.items()}
        errs = {r: float(e.max()) for r, e in errw.items()}
        bad += [f"{r} {errs[r]}" for r, e in errw.items()
                if not bool(torch.all(e <= 1e-5 * l1))]
        log(f"[3] ablation_taps[{v}] B={B} nwin={nwin} W={rc.shape[1]} "
            f"taps={T} plan {ab.plan(v, offs, smax)[:2]}: max_abs_err "
            + ", ".join(f"{r} {e:.4g}" for r, e in errs.items())
            + f" (tol 1e-5 of each window's L1 norm, min "
            f"{float(l1.min()):.4g}); repeat launches and graph replays "
            f"bit-identical: {'no' if bad else 'yes'}")
        if bad:
            raise AssertionError(f"ablation_taps[{v}] vs plain: {bad}")
        # the bytes the variant needs: the valid window samples, the union
        # of the replica ranges its taps read, the scalars, the taps out
        lg = ab.lags(v, offs, smax)
        span = (lg[0] if v == "onetap" else max(lg)) - min(lg)
        tc = 1 if v == "onetap" else T
        nbytes = float(nv.sum() * 4 + (nv + span).sum() * 4 + B * 12
                       + B * 2 * T * 4)
        flops = float(nv.sum()) * (4 * tc + 2 + (2 if v == "nosin" else 0))
        bms, by = bound(nbytes, flops)
        out = torch.empty_like(zk)
        copies = [[a.clone() for a in args]
                  for _ in range(copies_for(nbytes))]

        def on_copy(launch):
            return lambda c: launch(v, *copies[c], offs, smax, out)

        # device time: launches replayed from a CUDA graph
        cold = {r: graph_ms(on_copy(launch), len(copies))
                for r, launch in runs.items()}
        eager = {r: cold_ms(on_copy(launch), len(copies))
                 for r, launch in runs.items()}
        plain_ms = cuda_ms(lambda: ab.PLAIN[v](*args, offs, smax), 5)
        log(f"[3] ablation_taps[{v}]: {card_line()}; cluster kernel S="
            f"{ab.ctas_per_window()} CTAs per window, J="
            f"{ab.samples_per_thread()} samples per chain: cold "
            f"{cold['kernel']:.4f} ms/launch; v1 kernel cold "
            f"{cold['v1']:.4f} ms (device time: launches replayed from one "
            f"CUDA graph, inputs rotated over {len(copies)} copies, beyond "
            f"L2); eager back-to-back launches, cold: kernel "
            f"{eager['kernel']:.4f} ms, v1 {eager['v1']:.4f} ms; plain "
            f"{plain_ms:.4f} ms; bound {bms:.4f} ms by {by} "
            f"({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
        res[v] = dict(err=max(errs.values()), ms=cold["kernel"],
                      v1_ms=cold["v1"], eager_ms=eager["kernel"],
                      v1_eager_ms=eager["v1"], plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, timing="graph_replay")
        del copies
    return res


def phase_synth(dev, paths: dict, edge_starts: dict = None) -> float:
    """Every capture ({"slice", "pos", "fe1", "fe2", "rtl", "edge", "mh",
    "rx", "par_<scenario>", "ramp": path}, "fe1"/"fe2" phase 11's front
    ends, "rtl" and "edge" phase 12's, "rx" phase 14's (with the metadata
    receiver_throughput checks), "mh" phase 15's multi-process receiver
    demo's, "par_*" and "ramp" phase 16's (:func:`parity_signal`); the
    edge capture's channels start periods at ``edge_starts``), in 1 s
    chunks synthesized on ``dev`` (:func:`_synthesize`)."""
    from gnsslib_tpu_torch import sim
    from gnsslib_tpu_torch.constants import DType
    from gnsslib_tpu_torch.tools import receiver_throughput as rxt
    chunks = []
    edge = {p: (edge_starts[p], d) for p, d in EDGE_DOPPLER.items()} \
        if edge_starts else None
    for kind, seconds, f_sf, f_if, truth in (
            ("slice", SECONDS, F_SF, F_IF, TRUTH),
            ("pos", POS_SECONDS, F_SF, F_IF, TRUTH),
            ("fe1", MG_SECONDS, F_SF, F_IF, multi_truth()),
            ("fe2", MG_SECONDS, F_SF, 0.0, multi_truth()),
            ("rtl", RTL_SECONDS, RTL_SF, 0.0, RTL_TRUTH),
            ("edge", EDGE_SECONDS, F_SF, F_IF, edge),
            ("mh", MH_SECONDS, MH_SF, MH_IF, None),
            ("rx", RX_SECONDS, rxt.F_SF, rxt.F_IF, None)):
        if kind not in paths:
            continue
        n, step = int(seconds * f_sf), int(f_sf)
        chunks += [(kind, t0, min(step, n - t0), f_sf, f_if, truth)
                   for t0 in range(0, n, step)]
    parity = {k: parity_signal(k) for k in paths
              if k.startswith("par_") or k == "ramp"}
    for kind, sig in parity.items():
        n, step = int(sig[1] * sig[2]), int(sig[2])
        chunks += [(kind, t0, min(step, n - t0), sig[2], sig[3], None)
                   for t0 in range(0, n, step)]
    t0 = time.time()
    signals = {}          # (kind, dark): the satellites, built once
    with contextlib.ExitStack() as stack:
        files = {k: stack.enter_context(open(p, "wb"))
                 for k, p in paths.items()}
        for kind, c0, count, f_sf, f_if, truth in chunks:
            if kind in parity:
                chans, _, _, _, iq, noise, scale, fmt, seed = parity[kind]
                x = _synthesize(dev, chans, f_sf, f_if, iq, count, noise,
                                seed + c0, c0)
                files[kind].write(_quantize(x, fmt, scale, rtl_scale=scale))
                continue
            dark = kind == "pos" and POS_FADE[0] <= c0 / f_sf < POS_FADE[1]
            if (kind, dark) not in signals:
                signals[kind, dark] = _signal(kind, c0, f_sf, truth)
            chans, dtype, seed, fmt = signals[kind, dark]
            cn0, scale = RX_LEVELS if kind == "rx" else (CN0, QUANT)
            noise = sim.noise_std_for_cn0(1.0, cn0, f_sf, dtype)
            x = _synthesize(dev, chans, f_sf, f_if, dtype == DType.IQ, count,
                            noise, seed + c0, c0)
            files[kind].write(_quantize(x, fmt, scale))
    if "rx" in paths:
        with open(paths["rx"] + ".json", "w") as f:
            json.dump(dict(f_sf=rxt.F_SF, f_if=rxt.F_IF, seconds=RX_SECONDS,
                           n=rxt.NPRESENT), f)
    dt = time.time() - t0
    log(f"[4] synthesized {SECONDS:.0f} s x {len(TRUTH)} PRNs, "
        f"{POS_SECONDS:.0f} s x {len(pos_geometry()[0])} PRNs and phase 11's "
        f"{MG_SECONDS:.0f} s x ({len(TRUTH)} GPS + {len(MG_SBAS)} SBAS real, "
        f"{len(MG_G1)} G1 I/Q) at {F_SF/1e6:.3f} Msps, and phase 12's "
        f"{RTL_SECONDS:.0f} s x {len(RTL_TRUTH)} PRNs I/Q at "
        f"{RTL_SF/1e6:.3f} Msps (RTL-SDR u8) and {EDGE_SECONDS:.1f} s x "
        f"{len(EDGE_DOPPLER)} PRNs at the block's edges, phase 14's "
        f"{RX_SECONDS:.0f} s x {rxt.NPRESENT} PRNs at {rxt.F_SF / 1e6:.3f} "
        f"Msps, and phase 15's {MH_SECONDS:.0f} s x 4 PRNs at "
        f"{MH_SF / 1e6:.3f} Msps, and phase 16's "
        + ", ".join(f"{k} {sig[1]:.0f} s x {len(sig[0])} at "
                    f"{sig[2] / 1e6:.3f} Msps" for k, sig in parity.items())
        + f" in {dt:.1f} s on {dev.type} -> {paths}")
    return dt


def _bit_identical(a, b) -> bool:
    """Two (state, (packf, packi)) blocks equal bit for bit."""
    import torch

    def same(x, y):
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        return torch.equal(x, y)
    (sa, ha), (sb, hb) = a, b
    return (all(same(getattr(sa, k), getattr(sb, k))
                for k in sa.__dataclass_fields__)
            and all(same(x, y) for x, y in zip(ha, hb)))


def _replay_vs_eager(tag: str, eng, st, block, nsteps: int,
                     phase: str = "5") -> None:
    """One block of ``eng`` replayed from its program's graph against the
    eager loop from the same state: bit-identical, or raise."""
    import torch
    prog = eng.program(nsteps, block.shape)
    if prog.graph is None and block.device.type == "cuda":
        raise AssertionError(f"{tag}: no CUDA graph captured on the card")
    sync = torch.cuda.synchronize if block.is_cuda else (lambda: None)
    t0 = time.time()
    got = eng.run_block_start(st, block, nsteps)
    sync()
    t1 = time.time()
    ref = eng.run_block_eager(st, block, nsteps)
    sync()
    t2 = time.time()
    same = _bit_identical(got, ref)
    log(f"[{phase}] {tag} {nsteps} steps: replayed {t1 - t0:.3f} s, eager "
        f"{t2 - t1:.3f} s wall; captured in {prog.capture_s:.3f} s + "
        f"instantiated in {prog.instantiate_s:.3f} s, pool "
        f"{prog.pool_bytes / 1e6:.1f} MB; replay vs eager bit-identical: "
        f"{'yes' if same else 'NO'}")
    if not same:
        raise AssertionError(f"{tag}: replay differs from the eager loop")


def phase_fast_vs_cpu(dev, path: str, fe1: str = None, fe2: str = None):
    """The block programs replayed against the eager loop on the card (pull-
    in, and every backend from a synced state), then FastTracker on the
    card vs on the CPU (plain correlator) from one state: 4 locked + 4
    idle channels after a 1000-period pull-in.  With phase 11's front ends
    ``fe1`` and ``fe2``, the same for its other two channel groups (band
    backend): SBAS (L = 2) and GLONASS G1 on I/Q samples."""
    import torch
    from gnsslib_tpu_torch.constants import CodeType, DType
    from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                         state_from_numpy, state_to_numpy)
    prns = list(TRUTH) + [1, 2, 4, 5]
    nn = int(round(F_SF / 1000))
    x = np.fromfile(path, np.int8, count=1700 * nn).astype(np.float32)
    cpu = torch.device("cpu")
    trks = {d: Tracker(TrackConfig(6, 3, 6), prns,
                       [CodeType.L1CA] * len(prns), F_SF, F_IF, DType.REAL,
                       device=d) for d in (dev, cpu)}
    blocks = {d: torch.from_numpy(x).to(d) for d in (dev, cpu)}
    t = trks[dev]
    st = t.start_channels(t.init_state(), [0, 1, 2, 3],
                          [TRUTH[p][0] for p in TRUTH],
                          [-TRUTH[p][1] for p in TRUTH])
    _replay_vs_eager("pull-in", t, st, blocks[dev], 200)
    st, _ = t.run_block_eager(st, blocks[dev], 1000)
    for c in range(4):
        st = t.set_bit_sync(st, c, 0)
    for corr in ("band", "pallas", "fused", "xla"):
        f = FastTracker(t)
        f.corr = corr
        _replay_vs_eager(corr, f, st, blocks[dev], 300)
    snap = state_to_numpy(st)
    # the fetch backends run half as many steps: their CPU side costs
    # ~15-18 s per 600 steps of the script's time
    for corr, nsteps in (("band", 600), ("pallas", 300), ("fused", 300)):
        _fast_vs_cpu(corr, nsteps, trks, blocks, snap, dev, len(prns))
    if fe1 is not None:
        _group_programs(dev, fe1, fe2)


def _group_programs(dev, fe1: str, fe2: str) -> None:
    """Phase 11's SBAS group (3 channels, PRN 129 visible; loop every 2
    periods) on FE1 and G1 group (14 FDMA channels, 3 visible; I/Q, IF 0)
    on FE2: the pull-in and band programs replayed against the eager loop
    bit for bit, then the band FastTracker on the card vs the CPU from one
    state after a 1000-period pull-in (SBAS 120 steps, G1 300: 60 and 30
    loop updates, before the closed loops' last-bit differences can grow,
    as in tests/test_torch_fast.py)."""
    import torch
    from gnsslib_tpu_torch.constants import (CodeType, DFRQ1_GLO, DType,
                                             FREQ1_GLO)
    from gnsslib_tpu_torch.track import (FastTracker, TrackConfig, Tracker,
                                         state_to_numpy)
    nn = int(round(F_SF / 1000))
    cpu = torch.device("cpu")
    sbas = list(MG_SBAS) + [p for p in MG_SBAS_PRNS if p not in MG_SBAS]
    g1 = list(MG_G1) + [f for f in MG_G1_FCNS if f not in MG_G1]
    groups = (
        ("SBAS", fe1, sbas, CodeType.L1SBAS, F_IF, DType.REAL,
         [MG_SBAS[p] for p in MG_SBAS], {}, 120),
        ("G1 I/Q", fe2, g1, CodeType.G1, 0.0, DType.IQ,
         [MG_G1[f][1:] for f in MG_G1],
         dict(foffsets=[f * DFRQ1_GLO for f in g1],
              f_cfs=[FREQ1_GLO + f * DFRQ1_GLO for f in g1]), 300))
    for tag, path, prns, ctype, f_if, dtype, truth, kw, nsteps in groups:
        comp = 2 if dtype == DType.IQ else 1
        x = np.fromfile(path, np.int8, count=1700 * nn * comp).astype(
            np.float32).reshape((-1, comp) if comp == 2 else (-1,))
        trks = {d: Tracker(TrackConfig(*CORR), prns, [ctype] * len(prns),
                           F_SF, f_if, dtype, device=d, **kw)
                for d in (dev, cpu)}
        blocks = {d: torch.from_numpy(x).to(d) for d in (dev, cpu)}
        t = trks[dev]
        nact = len(truth)
        st = t.start_channels(t.init_state(), list(range(nact)),
                              [d for d, _ in truth], [-f for _, f in truth])
        _replay_vs_eager(f"{tag} pull-in", t, st, blocks[dev], 200)
        st, _ = t.run_block_eager(st, blocks[dev], 1000)
        for c in range(nact):
            st = t.set_bit_sync(st, c, 0)
        f = FastTracker(t)
        _replay_vs_eager(f"{tag} band (L={f.L})", f, st, blocks[dev], 300)
        _fast_vs_cpu("band", nsteps, trks, blocks, state_to_numpy(st), dev,
                     len(prns), nact=nact, tag=tag)


def _fast_vs_cpu(corr: str, nsteps: int, trks, blocks, snap, dev,
                 nch: int, nact: int = 4, tag: str = "") -> None:
    """One backend's ``nsteps`` on the card and on the CPU from ``snap``:
    loc identical, test_fast.py's inter-backend tolerances on ip/qp and
    dcarr of the ``nact`` locked channels, and on the card the backend's
    kernel launched, never its plain version."""
    import torch
    from gnsslib_tpu_torch.ops import band_taps, gram_taps, window_taps
    from gnsslib_tpu_torch.track import FastTracker, state_from_numpy
    counts = {"band": band_taps.COUNTS, "pallas": window_taps.COUNTS16,
              "fused": gram_taps.COUNTS}[corr]
    cpu = torch.device("cpu")
    outs = {}
    for d in (dev, cpu):
        f = FastTracker(trks[d])
        f.corr = corr
        counts.reset()
        t0 = time.time()
        _, outs[d] = f.run_block(state_from_numpy(snap, d), blocks[d],
                                 nsteps)
        name = ("FastTracker" if corr == "band" else
                f"FastTracker ({corr})") + (f" {tag}" if tag else "")
        log(f"[5] {name} {nsteps} steps x {nch} ch on {d.type}: "
            f"{time.time() - t0:.2f} s wall; kernel launches "
            f"{counts.kernel}, plain calls {counts.plain}")
        if d.type == "cuda" and (counts.kernel <= 0 or counts.plain != 0):
            raise AssertionError(f"FastTracker ({corr}) on the card: "
                                 f"{counts.kernel} launches, {counts.plain} "
                                 f"plain calls")
    a, b = outs[cpu], outs[dev]
    act = slice(0, nact)
    if not np.array_equal(a.loc[:, act], b.loc[:, act]):
        raise AssertionError(f"FastTracker ({corr}) loc differs between card "
                             "and CPU")
    scale = float(np.max(np.abs(a.ip[:, act])))
    for name in ("ip", "qp"):
        d = np.abs(getattr(a, name)[:, act] - getattr(b, name)[:, act])
        outl = int(np.sum(d > 5e-3 * scale))
        med = float(np.median(d))
        corr_min = min(np.corrcoef(getattr(a, name)[:, c],
                                   getattr(b, name)[:, c])[0, 1]
                       for c in range(nact))
        log(f"[5] {corr}{' ' + tag if tag else ''} {name}: outliers>5e-3*"
            f"scale {outl}, median/scale "
            f"{med / scale:.3g}, min corr {corr_min:.6f}")
        if outl > 3 or med >= 1e-3 * scale or corr_min <= 0.999:
            raise AssertionError(f"FastTracker ({corr}) {name} card vs CPU")
    dd = float(np.max(np.abs(a.dcarr[:, act] - b.dcarr[:, act])))
    log(f"[5] {corr}{' ' + tag if tag else ''} dcarr max diff {dd:.4g} Hz; "
        f"loc identical")
    if dd > 0.5:
        raise AssertionError(f"FastTracker ({corr}) dcarr card vs CPU")


def _write_ini(capture: str, name: str = "rx", rcv: str = "",
               output: str = "", prns=range(1, 33)) -> str:
    """INI files (receiver + front end) for L1CA channels on ``prns`` (all
    32 by default) on ``capture``, RINEX output under WORK/<name>/rinex;
    ``rcv`` and ``output`` are extra lines of the [RCV] and [OUTPUT]
    sections."""
    fend = os.path.join(WORK, f"{name}_fend.ini")
    with open(fend, "w") as f:
        f.write(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    ={capture}
[TRACK]
CORRN    ={CORR[0]}
CORRD    ={CORR[1]}
CORRP    ={CORR[2]}
""")
    ini = os.path.join(WORK, f"{name}.ini")
    nch = len(prns)
    ones = ",".join("1" for _ in prns)
    prns = ",".join(str(p) for p in prns)
    with open(ini, "w") as f:
        f.write(f"""[RCV]
FENDCONF ={fend}
{rcv}[CHANNEL]
NCH      ={nch}
PRN      ={prns}
SYS      ={ones}
CTYPE    ={ones}
FTYPE    ={ones}
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={WORK}/{name}/rinex
{output}""")
    return ini


def _receiver_programs(tag: str, rx, launches: int) -> list:
    """Check that ``rx``'s blocks (each channel group's, for a
    MultiReceiver) ran as replays of the graphs it captured when it was
    built: one program per engine, both replayed, and every K1 launch
    counted through the replays.  Returns each group's counted K1
    launches."""
    counted = []
    for g in getattr(rx, "rx", [rx]):
        progs = {"pull-in": list(g.trk.programs.values()),
                 "steady": list(g.fast.programs.values())}
        if any(len(p) != 1 or p[0].graph is None for p in progs.values()):
            raise AssertionError(f"{tag}: block programs {progs}")
        n = sum(p.replays * p.launches.get("band_taps", {}).get(
            "kernel", 0) for ps in progs.values() for p in ps)
        counted.append(n)
        log(f"[{tag}] block programs" + (
            f" of the group {sorted({c.cfg.ctype for c in g.channels})} on "
            f"FE{g.spec.ftype} (L={g.fast.L})" if g is not rx else "")
            + ": " + "; ".join(
                f"{k} {p[0].count} steps, captured in {p[0].capture_s:.3f} "
                f"s + instantiated in {p[0].instantiate_s:.3f} s, pool "
                f"{p[0].pool_bytes / 1e6:.1f} MB, {p[0].replays} replays of "
                f"{p[0].launches or 'no kernel launches'}"
                for k, p in progs.items())
            + f"; band_taps launches counted through the replays {n}")
        if min(p[0].replays for p in progs.values()) <= 0:
            raise AssertionError(f"{tag}: a program never replayed")
    if sum(counted) != launches:
        raise AssertionError(f"{tag}: launches counted {counted}, COUNTS "
                             f"{launches}")
    return counted


def _record(rx) -> list:
    """The epochs ``rx``'s hub emits, as (prn, tow, P, L, D, S) tuples
    (appended as the run emits them)."""
    epochs = []
    emit = rx.hub.emit_epochs

    def record(inputs):
        out = emit(inputs)
        epochs.extend([(o.prn, o.tow, o.P, o.L, o.D, o.S) for o in e]
                      for e in out)
        return out
    rx.hub.emit_epochs = record
    return epochs


def phase_slice(dev, capture: str) -> tuple:
    """The receiver's main path from an INI file; returns the kernel's
    launch count during the run, the run's events and epochs, and a dict
    of its acquisition decisions ({prn: (codei, dcarr)}), stage walls and
    wall."""
    import shutil
    from gnsslib_tpu_torch.constants import CLIGHT, PTIMING
    from gnsslib_tpu_torch.gtime import epoch2time, time2gpst
    from gnsslib_tpu_torch.io.frontend import FileFrontend
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import Receiver
    from gnsslib_tpu_torch.track.program import CAPTURES

    shutil.rmtree(os.path.join(WORK, "rx"), ignore_errors=True)
    cfg = load_ini(_write_ini(capture))
    fe = FileFrontend(cfg.files[0], cfg.fends[0])
    t0 = time.time()
    rx = Receiver(cfg, fe, device=dev, nsteps_per_block=400)
    log(f"[6] receiver built in {time.time() - t0:.2f} s (with its block "
        f"programs' warm-ups and captures)")
    captures = CAPTURES.captures
    epochs = _record(rx)
    bt.COUNTS.reset()
    t0 = time.time()
    stats = rx.run_seconds()
    rx.close()
    fe.close()
    launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    wall = time.time() - t0
    if dev.type == "cuda":
        _receiver_programs("6", rx, launches)
    if CAPTURES.captures != captures:
        raise AssertionError(f"{CAPTURES.captures - captures} captures "
                             "during the run")
    sw = stats["stage_wall"]
    tl = rx.timeline
    log(f"[6] slice: {stats['seconds']:.1f} s of stream in {wall:.1f} s; "
        f"wall by phase: acquire {sw['acquire']:.2f} s, pull-in "
        f"{sw['pullin']:.2f} s, steady {sw['steady']:.2f} s; milestones "
        + ", ".join(f"{k} {v:.2f} s" for k, v in tl.items() if k != "t0"))
    log(f"[6] locked {stats['locked']}, decoded {stats['decoded']}, "
        f"{stats['epochs']} epochs, {stats['ephs']} eph records; band_taps "
        f"launches {launches}, v1 launches {v1}, plain calls {plain}")
    for ev in rx.events:
        if ev[0] in ("acq", "nav:bitsync", "nav:decode"):
            log(f"[6]   event {ev}")

    by_prn = {ch.cfg.prn: ch for ch in rx.channels}
    for prn, (d, dop) in TRUTH.items():
        ch = by_prn[prn]
        derr = abs(ch.acq_codei - d)
        derr = min(derr, rx.nsamp - derr)
        # code phase within 2 samples, Doppler within one 200 Hz search
        # bin (test_acquire.py's bound: 1 ms coherent rounds make the
        # neighbouring bins nearly as strong)
        if not (ch.locked and derr <= 2 and abs(ch.acq_dcarr + dop) <= 200.0):
            raise AssertionError(f"PRN {prn}: acquisition codei "
                                 f"{ch.acq_codei} vs {d}, dcarr "
                                 f"{ch.acq_dcarr} vs {-dop}")
        if not (ch.synced and ch.nav.flagdec):
            raise AssertionError(f"PRN {prn}: no bit sync / TOW decode")
    false = [p for p, ch in by_prn.items() if ch.locked and p not in TRUTH]
    if false:
        raise AssertionError(f"absent PRNs acquired: {false}")
    if "steady" not in tl:
        raise AssertionError("the steady-state fast path never engaged")
    if launches <= 0 or v1 != 0 or plain != 0:
        raise AssertionError(f"band_taps launches {launches}, v1 {v1}, "
                             f"plain {plain}")
    if rx.ephs_written < len(TRUTH):
        raise AssertionError(f"only {rx.ephs_written} RINEX nav records")

    lines = open(rx.obs_writer.path).read().splitlines()
    heads = [i for i, ln in enumerate(lines) if ln.startswith(">")]
    if len(heads) < 10:
        raise AssertionError(f"only {len(heads)} RINEX obs epochs")
    last = heads[-1]
    tow, _ = time2gpst(epoch2time([float(v) for v in
                                   lines[last].split()[1:7]]))
    t = tow - PTIMING / 1000.0 - TOW0
    P = {int(ln[1:3]): float(ln[3:17])
         for ln in lines[last + 1:last + 1 + len(TRUTH)]}
    if sorted(P) != sorted(TRUTH):
        raise AssertionError(f"last epoch satellites {sorted(P)}")
    ref = min(TRUTH)
    for prn in TRUTH:
        expect = (CLIGHT / F_SF * (TRUTH[prn][0] - TRUTH[ref][0])
                  + CLIGHT * (TRUTH[prn][1] - TRUTH[ref][1]) / 1.57542e9 * t)
        got = P[prn] - P[ref]
        log(f"[6] G{prn:02d}-G{ref:02d} pseudorange {got:.3f} m, truth "
            f"{expect:.3f} m, diff {got - expect:+.3f} m")
        if abs(got - expect) > 15.0:
            raise AssertionError(f"PRN {prn}: pseudorange difference off by "
                                 f"{got - expect:.1f} m")
    log(f"[6] RINEX: {len(heads)} obs epochs, {rx.ephs_written} nav records "
        f"({rx.obs_writer.path})")
    ref = dict(decisions=_decisions(rx), stage_wall=dict(sw), wall=wall)
    return launches, rx.events, epochs, ref


def _decisions(rx) -> dict:
    """Each channel's acquisition decision: {prn: (codei, dcarr)} as the
    search reported them (-1, 0.0 for a channel never acquired)."""
    return {ch.cfg.prn: (ch.acq_codei, ch.acq_dcarr) for ch in rx.channels}


def phase_throughput(dev) -> dict:
    """bench.py's workload on the port: 32 channels, 2000-step blocks,
    noise block, a pending-subset search each block, depth-2 pipelining;
    the blocks replayed from the steady program's graph and, in turns in
    the same run, through the eager loop.  Returns the best Msamples/s of
    each."""
    import torch
    from collections import deque
    from gnsslib_tpu_torch.constants import CodeType, DType
    from gnsslib_tpu_torch.acquire import Acquirer
    from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker
    C, nsteps, blocks, passes = 32, 2000, 6, 3
    prns = list(range(1, 33))
    trk = Tracker(TrackConfig(6, 3, 6), prns, [CodeType.L1CA] * C, F_SF,
                  F_IF, DType.REAL, device=dev)
    fast = FastTracker(trk)
    acq = Acquirer(prns, [CodeType.L1CA] * C, F_SF, F_IF, DType.REAL,
                   device=dev)
    nsamp = trk.n_nom
    block_len = (blocks * nsteps * nsamp + trk.nwin + 8 * blocks * nsteps
                 + 2 * nsamp + 64)
    gen = torch.Generator(device=dev).manual_seed(3)
    block = torch.randint(-64, 64, (block_len,), generator=gen,
                          device=dev).to(torch.float32)
    pending = np.arange(12, 32)

    def start():
        st = trk.start_channels(trk.init_state(), list(range(C)),
                                [int(97 * p) % nsamp for p in prns],
                                [250.0 * (p % 13) - 1500.0 for p in prns])
        for c in range(C):
            st = trk.set_bit_sync(st, c, c % 10)
        return st

    t0 = time.time()
    prog = fast.program(nsteps, block.shape)
    log(f"[7] steady program of {prog.count} super-steps built in "
        f"{time.time() - t0:.2f} s (capture {prog.capture_s:.3f} s, "
        f"instantiate {prog.instantiate_s:.3f} s, pool "
        f"{prog.pool_bytes / 1e6:.1f} MB)")
    runs = {"replayed": fast.run_block_start, "eager": fast.run_block_eager}
    for run in runs.values():                                # warm-up
        run(start(), block, nsteps)
    acq.search_dev(block, idx=pending)
    best = {}
    for p in range(passes):
        for mode in (("replayed", "eager") if p % 2 == 0
                     else ("eager", "replayed")):
            run = runs[mode]
            st = start()
            torch.cuda.synchronize()
            t0 = time.time()
            pend = deque()
            for _b in range(blocks):
                ah = acq.search_dev_start(block, idx=pending)
                st, h = run(st, block, nsteps)
                pend.append((h, ah))
                if len(pend) > 2:
                    h, a = pend.popleft()
                    fast.run_block_collect(h)
                    acq.search_dev_collect(a)
            while pend:
                h, a = pend.popleft()
                fast.run_block_collect(h)
                acq.search_dev_collect(a)
            wall = (time.time() - t0) / blocks
            msps = nsteps * nsamp / 1e6 / wall
            best[mode] = max(best.get(mode, 0.0), msps)
            log(f"[7] pass {p + 1} {mode:8s}: {wall * 1e3:.1f} ms per "
                f"2000-step block -> {msps:.1f} Msamples/s")
    # the receiver's block at these 2000 steps, at the fixed block's
    # length (one period before the cursor) and at the length that
    # follows the channels: its cut from the device cache (int8 -> f32)
    # and the copy into the program's static block, by CUDA events
    from gnsslib_tpu_torch.runtime.receiver import block_geometry
    geo = block_geometry(nsteps, nsamp, trk.nwin)
    lens = {"fixed": geo["block_len"] + nsamp, "now": geo["span"]}
    src = torch.randint(-64, 64, (max(lens.values()),), generator=gen,
                        device=dev).to(torch.int8)
    dst = torch.empty(max(lens.values()), dtype=torch.float32, device=dev)
    cost = {k: cuda_ms(lambda n=n: dst[:n].copy_(src[:n].to(torch.float32)),
                       20) for k, n in lens.items()}
    per_block = nsteps * nsamp / 1e6 / best["replayed"] * 1e3
    log(f"[7] a receiver block's cut and copy at 2000 steps: fixed "
        f"{lens['fixed']} samples {cost['fixed']:.4f} ms, now {lens['now']} "
        f"samples {cost['now']:.4f} ms (+{cost['now'] - cost['fixed']:.4f} "
        f"ms, {100 * (cost['now'] - cost['fixed']) / per_block:.3f}% of a "
        f"replayed block's {per_block:.1f} ms)")
    log(f"[7] steady-state throughput, bench.py workload (32 ch, 2000-step "
        f"blocks, subset search per block, depth 2), best of {passes} "
        f"passes: replayed {best['replayed']:.1f} Msamples/s = "
        f"{best['replayed'] / (F_SF / 1e6):.2f}x real time, eager "
        f"{best['eager']:.1f} Msamples/s = "
        f"{best['eager'] / (F_SF / 1e6):.2f}x ({card_line()})")
    return best


def phase_profiler(dev) -> dict:
    """The correlator profiler at full width (32 channels, 50 super-steps
    per run): every backend eager and replayed and every probe, so K1-K5
    all launch, then 3 rounds of its duel (each backend eager, as a block
    graph and as a one-super-step graph, in turns); returns each kernel's
    launch count over the run."""
    from gnsslib_tpu_torch.ops import band_taps, gram_taps, window_taps
    from gnsslib_tpu_torch.tools import profile_fast
    counts = {"band_taps": band_taps.COUNTS, "gram_taps": gram_taps.COUNTS,
              "correlate_windows16": window_taps.COUNTS16,
              "correlate_windows8": window_taps.COUNTS8,
              "correlate_windows": window_taps.COUNTS5}
    for c in counts.values():
        c.reset()
    t0 = time.time()
    res = profile_fast.profile(dev, steps=50, channels=32,
                               log=lambda m: log(f"[8] {m}"))
    t1 = time.time()
    profile_fast.duel(dev, rounds=3, steps=50, channels=32,
                      log=lambda m: log(f"[8] {m}"))
    launches = {k: c.kernel for k, c in counts.items()}
    plain = {k: c.plain for k, c in counts.items()}
    v1 = {k: getattr(c, "v1", 0) for k, c in counts.items()}
    log(f"[8] profiler {t1 - t0:.1f} s, duel {time.time() - t1:.1f} s "
        f"({card_line()}); launches {launches}, v1 launches {v1}, plain "
        f"calls {plain}")
    for tag, rec in res.items():
        t = [rec["wall_ms"], rec["event_ms"]]
        if not all(np.isfinite(v) and v > 0 for v in t):
            raise AssertionError(f"profiler {tag}: times {t}")
        if "launches" in rec and (rec["launches"] != 1 or rec["plain"]):
            raise AssertionError(f"profiler {tag}: {rec['launches']} "
                                 f"launches, {rec['plain']} plain calls per "
                                 f"super-step")
    # every launch of K1-K5 through the cluster (K2: banded-Gram) kernels:
    # their offsets are tap_offsets(6, 3), smax 18
    if min(launches.values()) <= 0 or max(plain.values()) != 0 or \
            max(v1.values()) != 0:
        raise AssertionError(f"profiler launches {launches}, v1 {v1}, plain "
                             f"{plain}")
    return launches


def phase_kernel_profiler(dev) -> dict:
    """K6's profiler: each variant per wrapper call, its cluster and v1
    kernels by graph replay, then 100 chained launches eager and replayed
    from one CUDA graph; returns its launch counts."""
    from gnsslib_tpu_torch.ops import ablation_taps as ab
    from gnsslib_tpu_torch.tools import profile_kernel as pk
    for c in ab.COUNTS.values():
        c.reset()
    t0 = time.time()
    res = pk.profile(dev, reps=20, scan_test=True,
                     log=lambda m: log(f"[9] {m}"))
    launches = {v: c.kernel for v, c in ab.COUNTS.items()}
    v1 = {v: c.v1 for v, c in ab.COUNTS.items()}
    plain = {v: c.plain for v, c in ab.COUNTS.items()}
    log(f"[9] kernel profiler {time.time() - t0:.1f} s; launches "
        f"{launches} (graph capture counted once, replays not), v1 "
        f"launches {v1}, plain calls {plain}")
    for v, rec in res.items():
        t = [rec["ms"], rec["eager_ms_per_iter"], rec["graph_ms_per_iter"],
             rec["graph_ms"], rec["v1_graph_ms"]]
        if not all(x is not None and np.isfinite(x) and x > 0 for x in t):
            raise AssertionError(f"kernel profiler {v}: times {t}")
        log(f"[9] {v}: launch overhead per chained iteration "
            f"{t[1] - t[2]:.4f} ms (eager {t[1]:.4f} - graph {t[2]:.4f})")
    # every wrapper launch through the cluster kernel: the tool's lags are
    # progressions for every variant
    if min(launches.values()) <= 0 or max(plain.values()) != 0 or \
            max(v1.values()) != 0:
        raise AssertionError(f"kernel profiler launches {launches}, v1 {v1}, "
                             f"plain {plain}")
    return dict(launches=sum(launches.values()), res=res)


def _rinex_epochs(path: str) -> list:
    """[(epoch header line, {satellite id: P})] of a RINEX 3 obs file
    (ids as "G03", "R13", "S29")."""
    out = []
    for ln in open(path).read().splitlines():
        if ln.startswith(">"):
            out.append((ln, {}))
        elif out and ln[:1] in "GRSJ" and ln[1:3].isdigit():
            out[-1][1][ln[:3]] = float(ln[3:17])
    return out


def _rtcm_frames(buf: bytes) -> list:
    """[(message type, frame)] of an RTCM3 byte stream; raises on a bad
    preamble, a truncated frame or a CRC-24Q mismatch."""
    from gnsslib_tpu_torch.nav.bits import crc24q
    frames, pos = [], 0
    while pos < len(buf):
        if buf[pos] != 0xD3:
            raise AssertionError(f"RTCM: no preamble at byte {pos}")
        n = ((buf[pos + 1] & 0x03) << 8) | buf[pos + 2]
        msg = buf[pos:pos + n + 6]
        if len(msg) != n + 6 or crc24q(msg[:n + 3]) != int.from_bytes(
                msg[n + 3:], "big"):
            raise AssertionError(f"RTCM: bad frame at byte {pos}")
        frames.append(((msg[3] << 4) | (msg[4] >> 4), msg))
        pos += n + 6
    return frames


def phase_positioning(dev, capture: str, prns=range(1, 33)) -> int:
    """The positioning receiver from INI files with channels on ``prns``
    (all 32 GPS PRNs by default); returns its band_taps launches.  Then
    the CLI's --checkpoint/--resume against an uninterrupted run."""
    import shutil
    import socket
    from gnsslib_tpu_torch.io.frontend import FileFrontend
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime import cli
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import Receiver
    from gnsslib_tpu_torch.track.program import CAPTURES

    geo, _ = pos_geometry()
    visible = sorted(g["prn"] for g in geo)
    if len(visible) != 7 or POS_FADED not in visible:
        raise AssertionError(f"positioning geometry: visible {visible}")
    rcv = "RELOCK   =1\nACQCONFIRM=1\nHOTSTART =1\n"
    out = ("SPP      =1\nRAIM     =10\nRTCM     =1\nRTCMPORT =0\nLOG      =1\n"
           "LOGPATH  ={WORK}/{name}/log\n")
    for name in ("pos", "ck1", "ck2", "full"):
        shutil.rmtree(os.path.join(WORK, name), ignore_errors=True)
    ini = _write_ini(capture, "pos", rcv, out.format(WORK=WORK, name="pos")
                     + "SMOOTH   =20\n", prns)
    cfg = load_ini(ini)
    fe = FileFrontend(cfg.files[0], cfg.fends[0])
    rx = Receiver(cfg, fe, device=dev, nsteps_per_block=400)
    srv = rx.hub.rtcm_srv
    client = socket.create_connection(("127.0.0.1", srv.port))
    for _ in range(500):
        if srv.nclients:
            break
        time.sleep(0.01)
    if srv.nclients != 1:
        raise AssertionError("RTCM client not accepted")
    captures = CAPTURES.captures
    bt.COUNTS.reset()
    t0 = time.time()
    stats = rx.run_seconds()
    rx.close()
    fe.close()
    launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    wall = time.time() - t0
    if dev.type == "cuda":
        _receiver_programs("10", rx, launches)
        if CAPTURES.captures != captures:
            raise AssertionError(f"{CAPTURES.captures - captures} captures "
                                 "during the run")
    client.settimeout(5.0)
    buf = b""
    while True:
        chunk = client.recv(65536)
        if not chunk:
            break
        buf += chunk
    client.close()
    frames = _rtcm_frames(buf)
    types = {}
    for t, _ in frames:
        types[t] = types.get(t, 0) + 1
    sw = stats["stage_wall"]
    log(f"[10] positioning: {stats['seconds']:.1f} s of stream in "
        f"{wall:.1f} s; wall by phase: acquire {sw['acquire']:.2f} s, "
        f"pull-in {sw['pullin']:.2f} s, steady {sw['steady']:.2f} s; "
        f"milestones " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                   rx.timeline.items() if k != "t0"))
    log(f"[10] visible {visible}; locked {stats['locked']}, decoded "
        f"{stats['decoded']}, {stats['epochs']} epochs, {stats['ephs']} eph "
        f"records; band_taps launches {launches}, v1 launches {v1}, plain "
        f"calls {plain}; "
        f"RTCM frames by type {types} ({len(buf)} bytes)")
    ev = rx.events
    for e in ev:
        if e[0] in ("acq", "hot", "lol") or (e[0] == "nav:bitsync"
                                             and e[2] == POS_FADED):
            log(f"[10]   event {e}")
    for prn in visible:
        if not any(e[0] == "acq" and e[2] == prn for e in ev):
            raise AssertionError(f"PRN {prn} never acquired")
        if not any(e[0] == "nav:decode" and e[2] == prn for e in ev):
            raise AssertionError(f"PRN {prn} never decoded")
    lol = [e for e in ev if e[0] == "lol" and e[2] == POS_FADED]
    if not lol or not POS_FADE[0] <= lol[0][1] <= POS_FADE[1] + 1.5:
        raise AssertionError(f"faded PRN {POS_FADED}: lol events {lol}")
    back = [e for e in ev if e[0] in ("hot", "acq") and e[2] == POS_FADED
            and e[1] >= lol[0][1]]
    resync = [e for e in ev if e[0] == "nav:bitsync" and e[2] == POS_FADED
              and back and e[1] > back[0][1]]
    if not back or not resync:
        raise AssertionError(f"faded PRN {POS_FADED}: restarts {back}, bit "
                             f"syncs after it {resync}")
    errs = [float(np.linalg.norm(p - np.asarray(POS_RCV)))
            for _, _, p, _, _ in rx.hub.positions]
    good = sum(e < 30.0 for e in errs)
    if errs:
        log(f"[10] SPP: {len(errs)} fixes ({good} within 30 m of the truth); "
            f"error min {min(errs):.2f} m, median {np.median(errs):.2f} m, "
            f"max {max(errs):.2f} m; satellites per fix "
            f"{sorted({f[4] for f in rx.hub.positions})}")
    if good < 3:
        raise AssertionError(f"only {good} SPP fixes within 30 m: {errs}")
    rinex = os.path.dirname(rx.obs_writer.path)
    pos_file = rx.obs_writer.path[:-4] + ".pos"
    rows = [ln for ln in open(pos_file) if not ln.startswith("%")]
    if len(rows) != len(errs):
        raise AssertionError(f".pos rows {len(rows)} != fixes {len(errs)}")
    if types.get(1019, 0) < len(visible) or types.get(1077, 0) < 1:
        raise AssertionError(f"RTCM frames by type {types}")
    logs = sorted(os.listdir(os.path.join(WORK, "pos", "log")))
    if len(logs) != len(prns) or any(os.path.getsize(os.path.join(
            WORK, "pos", "log", f"logG{p:02d}.csv")) < 1000 for p in visible):
        raise AssertionError(f"track logs {logs}")
    if dev.type == "cuda" and (launches <= 0 or v1 != 0 or plain != 0):
        raise AssertionError(f"band_taps launches {launches}, v1 {v1}, "
                             f"plain {plain}")
    log(f"[10] .pos {len(rows)} rows, {len(logs)} track logs in {rinex}/..")

    # checkpoint at 14 s and resume, on the CLI, against an uninterrupted
    # run (no smoothing: the Hatch filter's state is not in a checkpoint)
    ck = os.path.join(WORK, "pos.ckpt")
    ckini = {name: _write_ini(capture, name, rcv,
                              out.format(WORK=WORK, name=name), prns)
             for name in ("ck1", "ck2", "full")}
    walls = {}
    for name, extra in (("ck1", ["--seconds", str(CKPT_SECONDS),
                                 "--checkpoint", ck]),
                        ("ck2", ["--resume", ck]), ("full", [])):
        t0 = time.time()
        rc = cli.main([ckini[name], "--device", dev.type, "--quiet"] + extra)
        walls[name] = time.time() - t0
        if rc != 0:
            raise AssertionError(f"CLI {name} exit {rc}")
    eps = {}
    for name in ("ck1", "ck2", "full"):
        d = os.path.join(WORK, name, "rinex")
        obs = [f for f in os.listdir(d) if f.endswith(".obs")]
        eps[name] = _rinex_epochs(os.path.join(d, obs[0]))
    cut = len(eps["ck1"])
    tail = eps["full"][cut:]
    worst = 0.0
    if cut < 1 or len(eps["ck2"]) < 10 or len(tail) != len(eps["ck2"]):
        raise AssertionError(f"epochs: {cut} before the checkpoint, "
                             f"{len(eps['ck2'])} resumed, {len(tail)} in the "
                             f"uninterrupted run after it")
    for (ha, pa), (hb, pb) in zip(tail, eps["ck2"]):
        if ha != hb or sorted(pa) != sorted(pb):
            raise AssertionError(f"resumed epoch {hb!r} {sorted(pb)} != "
                                 f"{ha!r} {sorted(pa)}")
        worst = max([worst] + [abs(pa[k] - pb[k]) for k in pa])
    log(f"[10] checkpoint at {CKPT_SECONDS:.0f} s ({cut} epochs before it; "
        f"CLI wall {walls['ck1']:.1f} s), resumed ({len(eps['ck2'])} epochs, "
        f"{walls['ck2']:.1f} s) vs uninterrupted ({len(eps['full'])} epochs, "
        f"{walls['full']:.1f} s): same epochs and satellites, pseudoranges "
        f"within {worst:.4f} m")
    if worst > 1.0:
        raise AssertionError(f"resumed pseudoranges differ by {worst} m")
    return launches


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _tcp_reader(port: int, buf: bytearray):
    """A thread that connects to ``port`` on this host (retrying until
    the server listens) and appends everything it reads to ``buf`` until
    the server closes."""
    import socket
    import threading

    def run():
        for _ in range(600):
            try:
                sk = socket.create_connection(("127.0.0.1", port),
                                              timeout=0.5)
                break
            except OSError:
                time.sleep(0.1)
        else:
            return
        sk.settimeout(2.0)
        while True:
            try:
                d = sk.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not d:
                break
            buf.extend(d)
        sk.close()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _novatel_frames(buf: bytes) -> int:
    """The NovAtel RAWSBASFRAME frames (sync AA 44 12, message id 973,
    80 bytes with a CRC-32) in ``buf``; raises on a bad one."""
    from gnsslib_tpu_torch.nav.bits import crc32_rtk
    starts = [m.start() for m in re.finditer(b"\xaa\x44\x12", buf)]
    for i in starts:
        frame = buf[i:i + 80]
        if len(frame) != 80 or frame[4] | (frame[5] << 8) != 973 or \
                int.from_bytes(frame[76:80], "little") != \
                crc32_rtk(frame[:76]):
            raise AssertionError(f"NovAtel: bad frame at byte {i}")
    return len(starts)


def _write_multi_ini(fe1: str, fe2: str, gps, sbas, g1, rtcmport: int,
                     sbasport: int) -> str:
    """Phase 11's INI files: FE1 (real, ``F_IF``) and FE2 (I/Q, IF 0,
    1602 MHz) of ``TYPE=FILE`` with ``FILE1``/``FILE2``; GPS L1CA channels
    ``gps`` and SBAS ``sbas`` on FE1, G1 FDMA channels ``g1`` on FE2;
    RINEX, RTCM and SBAS output."""
    fend = os.path.join(WORK, "multi_fend.ini")
    with open(fend, "w") as f:
        f.write(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    ={fe1}
CF2      =1602.0e6
SF2      ={F_SF}
IF2      =0.0
DTYPE2   =2
FILE2    ={fe2}
[TRACK]
CORRN    ={CORR[0]}
CORRD    ={CORR[1]}
CORRP    ={CORR[2]}
""")
    chans = ([(p, 1, 1, 1) for p in gps] + [(p, 2, 27, 1) for p in sbas]
             + [(f, 4, 20, 2) for f in g1])
    col = [",".join(str(c[k]) for c in chans) for k in range(4)]
    ini = os.path.join(WORK, "multi.ini")
    with open(ini, "w") as f:
        f.write(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      ={len(chans)}
PRN      ={col[0]}
SYS      ={col[1]}
CTYPE    ={col[2]}
FTYPE    ={col[3]}
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={WORK}/multi/rinex
RTCM     =1
RTCMPORT ={rtcmport}
SBAS     =1
SBASPORT ={sbasport}
""")
    return ini


def phase_multi(dev, fe1: str, fe2: str, gps=range(1, 33),
                sbas=MG_SBAS_PRNS, g1=MG_G1_FCNS) -> tuple:
    """The multi-GNSS receiver from INI files on the CLI: GPS L1CA
    channels ``gps`` and SBAS channels ``sbas`` on FE1, GLONASS G1
    channels ``g1`` on the I/Q FE2; three channel groups (GPS L = 10, SBAS
    L = 2, G1 L = 10) stepped in lockstep with one output hub.  TCP clients
    read the RTCM3 and NovAtel SBAS streams.  Returns (K1 launches during
    the run, those of the I/Q group)."""
    import shutil
    from gnsslib_tpu_torch.constants import (CLIGHT, DFRQ1_GLO, FREQ1,
                                             FREQ1_GLO, PTIMING)
    from gnsslib_tpu_torch.gtime import epoch2time, time2gpst
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime import cli
    from gnsslib_tpu_torch.track.program import CAPTURES

    shutil.rmtree(os.path.join(WORK, "multi"), ignore_errors=True)
    ports = {"rtcm": _free_port(), "sbas": _free_port()}
    ini = _write_multi_ini(fe1, fe2, gps, sbas, g1, ports["rtcm"],
                           ports["sbas"])
    bufs = {k: bytearray() for k in ports}
    readers = [_tcp_reader(ports[k], bufs[k]) for k in ports]
    built = []                # the receiver the CLI builds, for the checks
    make = cli.build_receiver

    def keep(*a, **kw):
        built.append(make(*a, **kw))
        # the counts start when the run does: the programs' eager warm-ups
        # while the groups were built launched K1 too
        bt.COUNTS.reset()
        return built[-1]
    cli.build_receiver = keep
    captures = CAPTURES.captures
    t0 = time.time()
    try:
        rc = cli.main([ini, "--device", dev.type, "--quiet"])
    finally:
        cli.build_receiver = make
    wall = time.time() - t0
    launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    for th in readers:
        th.join(30)
    if rc != 0 or not built:
        raise AssertionError(f"CLI exit {rc}")
    rx = built[0]
    groups = getattr(rx, "rx", [rx])
    desc = [(g.spec.ftype, "iq" if g.spec.dtype == 2 else "real",
             g.fast.L if g.fast else None, len(g.channels)) for g in groups]
    log(f"[11] {len(rx.channels)} channels in {len(groups)} groups "
        f"(FE, samples, L, channels) {desc}; CLI wall {wall:.1f} s, "
        f"{CAPTURES.captures - captures} graph captures while building")
    if len(groups) != 3:
        raise AssertionError(f"groups {desc}")
    counted = ([0] * len(groups) if dev.type != "cuda" else
               _receiver_programs("11", rx, launches))
    iq = sum(n for n, g in zip(counted, groups) if g.spec.dtype == 2)
    sw = {k: sum(g.stage_wall[k] for g in groups)
          for k in groups[0].stage_wall}
    log(f"[11] multi-GNSS: {groups[0].base / F_SF:.1f} s of stream on 2 RF "
        f"paths in {wall:.1f} s (CLI, building included); wall by phase "
        f"(summed over the groups): acquire {sw['acquire']:.2f} s, pull-in "
        f"{sw['pullin']:.2f} s, steady {sw['steady']:.2f} s; milestones "
        + ", ".join(f"{k} {v:.2f} s" for k, v in rx.timeline.items()
                    if k != "t0"))
    for g in groups:
        log(f"[11]   group FE{g.spec.ftype} L={g.fast.L}: wall by phase "
            + ", ".join(f"{k} {v:.2f} s" for k, v in g.stage_wall.items()))
    sbas_g = next(g for g in groups if g.fast.L == 2)
    log(f"[11] with the native SBAS decoder: the SBAS group's steady wall "
        f"{sbas_g.stage_wall['steady']:.2f} s (with the "
        f"pure-Python Viterbi: 20.13 s), the phase's CLI wall {wall:.1f} s "
        f"(then 39.3 s; NVIDIA H100 80GB HBM3, 700 W)")
    log(f"[11] band_taps launches {launches}, v1 launches {v1}, plain calls "
        f"{plain}; {rx.epochs_written} epochs, {rx.ephs_written} nav "
        f"records")
    log(f"[11] band_taps I/Q launches (the G1 group on FE2) {iq}")
    for ev in rx.events:
        if ev[0] in ("acq", "nav:bitsync") or (ev[0] == "nav:decode"
                                               and ev[3] in (1, 4)):
            log(f"[11]   event {ev}")

    nn = groups[0].nsamp
    visible = ([(prn, "G", TRUTH[prn][0], TRUTH[prn][1], FREQ1, f"G{prn:02d}")
                for prn in TRUTH]
               + [(prn, "S", d, dop, FREQ1, f"S{prn - 100:02d}")
                  for prn, (d, dop) in MG_SBAS.items()]
               + [(fcn, "R", d, dop, FREQ1_GLO + fcn * DFRQ1_GLO,
                   f"R{slot:02d}") for fcn, (slot, d, dop) in MG_G1.items()])
    letter = {1: "G", 2: "S", 4: "R"}          # SYS_GPS, SYS_SBS, SYS_GLO
    by_key = {(letter[ch.cfg.sys], ch.cfg.prn): ch for ch in rx.channels}
    for prn, sysc, d, dop, _, sid in visible:
        ch = by_key[(sysc, prn)]
        derr = abs(ch.acq_codei - d)
        derr = min(derr, nn - derr)
        if not (ch.locked and derr <= 2 and abs(ch.acq_dcarr + dop) <= 200.0):
            raise AssertionError(f"{sid} ({sysc} {prn}): acquisition codei "
                                 f"{ch.acq_codei} vs {d}, dcarr "
                                 f"{ch.acq_dcarr} vs {-dop}")
        if not (ch.synced and ch.nav.flagdec):
            raise AssertionError(f"{sid}: no bit sync / decode")
        if sysc == "R" and ch.nav.prn != int(sid[1:]):
            raise AssertionError(f"G1 FCN {prn}: slot {ch.nav.prn}, not "
                                 f"{sid}")
    vis = {(s_, p) for p, s_, *_ in visible}
    false = [k for k, ch in by_key.items() if ch.locked and k not in vis]
    if false:
        raise AssertionError(f"absent channels acquired: {false}")
    if dev.type == "cuda" and (launches <= 0 or iq <= 0 or v1 != 0
                               or plain != 0):
        raise AssertionError(f"band_taps launches {launches} (I/Q {iq}), v1 "
                             f"{v1}, plain {plain}")

    eps = _rinex_epochs(rx.obs_writer.path)
    head, P = eps[-1]
    want = sorted(v[5] for v in visible)
    if len(eps) < 10 or sorted(P) != want:
        raise AssertionError(f"{len(eps)} RINEX epochs; the last holds "
                             f"{sorted(P)}, not {want}")
    tow, _ = time2gpst(epoch2time([float(v) for v in head.split()[1:7]]))
    t = tow - PTIMING / 1000.0 - MG_TOW
    ref = min(TRUTH)
    d0, f0 = TRUTH[ref]
    worst = 0.0
    ms = CLIGHT / 1000.0
    for prn, sysc, d, dop, f_cf, sid in visible:
        expect = (CLIGHT / F_SF * (d - d0)
                  + CLIGHT * (dop / f_cf - f0 / FREQ1) * t)
        got = P[sid] - P[f"G{ref:02d}"]
        off = got - expect
        # SBAS: both packages' framer anchors its time a whole number of
        # code periods away from GPS time (24 ms on this stream); the
        # range within the code period is what is checked
        whole = round(off / ms) if sysc == "S" else 0
        worst = max(worst, abs(off - whole * ms))
        log(f"[11] {sid}-G{ref:02d} pseudorange {got:.3f} m, truth "
            f"{expect:.3f} m, diff {off:+.3f} m"
            + (f" = {whole} ms {off - whole * ms:+.3f} m" if whole else ""))
    if worst > 15.0:
        raise AssertionError(f"cross-system pseudoranges off by up to "
                             f"{worst:.1f} m")
    nav = open(rx.nav_writer.path).read().splitlines()
    recs = {ln[0] for ln in nav if re.match(r"[GR]\d\d \d{4} ", ln)}
    if recs != {"G", "R"}:
        raise AssertionError(f"nav records of systems {recs}")
    types = {}
    for mt, _ in _rtcm_frames(bytes(bufs["rtcm"])):
        types[mt] = types.get(mt, 0) + 1
    nova = _novatel_frames(bytes(bufs["sbas"]))
    log(f"[11] RINEX: {len(eps)} epochs, last {sorted(P)}; nav records of "
        f"{sorted(recs)}; RTCM frames by type {types} "
        f"({len(bufs['rtcm'])} bytes); NovAtel RAWSBASFRAME frames {nova} "
        f"({len(bufs['sbas'])} bytes); cross-system pseudoranges within "
        f"{worst:.2f} m of the truth")
    if any(types.get(k, 0) < 1 for k in (1019, 1020, 1077, 1087)) or \
            nova < 1:
        raise AssertionError(f"RTCM frames by type {types}, NovAtel frames "
                             f"{nova}")
    return launches, iq


def phase_live(dev, capture: str, ref_events, ref_epochs) -> int:
    """Phase 12 (a): the slice's capture streamed live at LIVE_RATE x real
    time by a pacer process through ``ProcessFrontend`` into
    ``Receiver.run_live`` (32 channels, 400-step blocks replayed from the
    graphs), held bit for bit against phase 6's file replay of the same
    bytes (events and epochs).  Returns K1's launches during the run."""
    import shutil
    from gnsslib_tpu_torch.io import ProcessFrontend
    from gnsslib_tpu_torch.io.devcache import LiveBlockCache
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import Receiver
    from gnsslib_tpu_torch.track.program import CAPTURES

    shutil.rmtree(os.path.join(WORK, "live"), ignore_errors=True)
    cfg = load_ini(_write_ini(capture, "live"))
    cfg.rinex = False
    pacer = os.path.join(WORK, "pacer.py")
    with open(pacer, "w") as f:
        f.write(PACER)
    go = os.path.join(WORK, "pacer.go")
    if os.path.exists(go):
        os.unlink(go)
    argv = [sys.executable, pacer, capture, str(int(F_SF)), str(LIVE_RATE),
            go]
    with ProcessFrontend(argv, cfg.fends[0], ring_bytes=256 << 20) as fe:
        t0 = time.time()
        rx = Receiver(cfg, fe, device=dev, nsteps_per_block=400)
        if not isinstance(rx.cache, LiveBlockCache):
            raise AssertionError(f"live cache {type(rx.cache)}")
        log(f"[12a] receiver built in {time.time() - t0:.2f} s; block "
            f"{rx.span} samples (origin {rx.lead} before the earliest "
            f"channel, room {rx.room}), the pacer at {LIVE_RATE}x real time "
            f"({F_SF / 1e6 * LIVE_RATE:.3f} MB/s through a pipe)")
        epochs = _record(rx)
        captures = CAPTURES.captures
        bt.COUNTS.reset()
        open(go, "w").close()
        t0 = time.time()
        stats = rx.run_live()
        wall = time.time() - t0
        launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
        rx.close()
        overruns, produced = fe.overruns, fe.nsamples
    if dev.type == "cuda":
        _receiver_programs("12a", rx, launches)
    sw = stats["stage_wall"]
    log(f"[12a] live: {stats['seconds']:.1f} s of stream ({produced} samples "
        f"produced) in {wall:.1f} s; wall by phase: acquire "
        f"{sw['acquire']:.2f} s, pull-in {sw['pullin']:.2f} s, steady "
        f"{sw['steady']:.2f} s; largest lag behind the producer "
        f"{stats['lag']:.3f} s; overruns {overruns}; uploaded "
        f"{rx.cache.uploaded_samples} samples once each")
    log(f"[12a] locked {stats['locked']}, decoded {stats['decoded']}, "
        f"{stats['epochs']} epochs; band_taps launches {launches}, v1 "
        f"{v1}, plain {plain}")
    if overruns or CAPTURES.captures != captures:
        raise AssertionError(f"overruns {overruns}, captures during the run "
                             f"{CAPTURES.captures - captures}")
    if rx.events != ref_events:
        raise AssertionError(f"live events differ from the file replay's: "
                             f"{rx.events[:3]} vs {ref_events[:3]}")
    if not epochs or epochs != ref_epochs:
        bad = next((i for i, (a, b) in enumerate(zip(epochs, ref_epochs))
                    if a != b), min(len(epochs), len(ref_epochs)))
        raise AssertionError(f"live epochs ({len(epochs)}) differ from the "
                             f"file replay's ({len(ref_epochs)}) at {bad}")
    log(f"[12a] events ({len(ref_events)}) and epochs ({len(epochs)}, "
        f"pseudoranges, phases, Dopplers, C/N0) equal phase 6's file replay "
        f"bit for bit")
    if launches <= 0 or v1 != 0 or plain != 0:
        raise AssertionError(f"band_taps launches {launches}, v1 {v1}, "
                             f"plain {plain}")
    return launches


def phase_live_rtlsdr(dev, capture: str) -> int:
    """Phase 12 (b): the CLI with ``TYPE=RTLSDR`` on the mock librtlsdr
    (built from tools/mock_rtlsdr.c with gcc), which streams ``capture``
    (RTL-SDR u8 I/Q at RTL_SF) in real time through the in-process
    binding; 32 L1CA channels.  Every visible PRN must be acquired,
    locked, bit-synced and tracked through K1's I/Q kernel.  Returns K1's
    launches during the run."""
    import contextlib
    import io
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime import cli

    lib = os.path.join(WORK, "libmock_rtlsdr.so")
    subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", lib,
                    os.path.join(ROOT, "tools", "mock_rtlsdr.c")],
                   check=True, capture_output=True)
    fend = os.path.join(WORK, "rtl_fend.ini")
    with open(fend, "w") as f:
        f.write(f"""[FEND]
TYPE     =RTLSDR
CF1      =1575.42e6
SF1      ={RTL_SF}
IF1      =0.0
DTYPE1   =2
[TRACK]
CORRN    ={RTL_CORR[0]}
CORRD    ={RTL_CORR[1]}
CORRP    ={RTL_CORR[2]}
""")
    ini = os.path.join(WORK, "rtl.ini")
    ones = ",".join("1" for _ in range(32))
    with open(ini, "w") as f:
        f.write(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      =32
PRN      ={",".join(str(p) for p in range(1, 33))}
SYS      ={ones}
CTYPE    ={ones}
FTYPE    ={ones}
[OUTPUT]
OUTMS    =400
RINEX    =0
""")
    built = []
    make = cli.build_receiver

    def keep(*a, **kw):
        built.append(make(*a, **kw))
        bt.COUNTS.reset()          # the warm-ups while building launch K1
        return built[-1]
    env = {k: os.environ.get(k) for k in ("GNSSLIB_RTLSDR_LIB",
                                          "MOCK_RTLSDR_FILE")}
    os.environ.update(GNSSLIB_RTLSDR_LIB=lib, MOCK_RTLSDR_FILE=capture)
    cli.build_receiver = keep
    out = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([ini, "--device", dev.type, "--seconds",
                           str(RTL_RUN)])
    finally:
        cli.build_receiver = make
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.time() - t0
    launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    text = out.getvalue()
    if rc != 0 or not built or "live capture" not in text:
        raise AssertionError(f"CLI exit {rc}: {text[-2000:]}")
    rx = built[0]
    if dev.type == "cuda":
        _receiver_programs("12b", rx, launches)
    done = next((ln for ln in text.splitlines() if ln.startswith("done:")),
                "")
    lag = next((ln for ln in text.splitlines() if ln.startswith("live:")),
               "")
    log(f"[12b] CLI TYPE=RTLSDR (mock librtlsdr, {RTL_SF / 1e6:.3f} Msps "
        f"I/Q u8, real time): exit {rc}, wall {wall:.1f} s; {done}; {lag}; "
        f"band_taps launches (I/Q) {launches}, v1 {v1}, plain {plain}")
    by_prn = {ch.cfg.prn: ch for ch in rx.channels}
    nn = rx.nsamp
    for prn, (d, dop) in RTL_TRUTH.items():
        ch = by_prn[prn]
        derr = abs(ch.acq_codei - d)
        derr = min(derr, nn - derr)
        if not (ch.locked and ch.synced and derr <= 2
                and abs(ch.acq_dcarr + dop) <= 200.0):
            raise AssertionError(f"PRN {prn}: locked {ch.locked}, synced "
                                 f"{ch.synced}, codei {ch.acq_codei} vs "
                                 f"{d}, dcarr {ch.acq_dcarr} vs {-dop}")
    false = [p for p, ch in by_prn.items() if ch.locked and p not in
             RTL_TRUTH]
    if false or "steady" not in rx.timeline:
        raise AssertionError(f"absent PRNs acquired {false}; milestones "
                             f"{rx.timeline}")
    if launches <= 0 or v1 != 0 or plain != 0 or rx.spec.dtype != 2:
        raise AssertionError(f"band_taps launches {launches}, v1 {v1}, "
                             f"plain {plain}, dtype {rx.spec.dtype}")
    log(f"[12b] visible PRNs {sorted(RTL_TRUTH)} acquired (code phase "
        f"within 2 samples, Doppler within 200 Hz), locked and bit-synced; "
        f"the steady state ran through K1's I/Q kernel")
    # the instantiation this run launched (I/Q, 9 taps 2 samples apart,
    # 2046-sample windows), held against the plain version at the run's
    # super-step (its channels x the steady program's windows)
    if dev.type == "cuda":
        trk, _, _, _, _, errs, _ = hold_k1(
            dev, True, "12b", corr=RTL_CORR, sf=RTL_SF, fif=0.0,
            windows=rx.fast.L)
        if (tuple(trk.offsets) != tuple(rx.trk.offsets)
                or trk.nwin != rx.trk.nwin or len(rx.channels) != 32):
            raise AssertionError(f"12b: held K1 at offsets {trk.offsets}, "
                                 f"nwin {trk.nwin}; the run's "
                                 f"{rx.trk.offsets}, {rx.trk.nwin}")
        return launches, max(errs.values())
    return launches, 0.0


def edge_starts() -> dict:
    """Phase 12 (c)'s channels: PRN -> the sample where its code period
    starts at EDGE_B0, EDGE samples inside the fixed block's edges (the
    block [base - nsamp, base + block_len) of the tracking geometry at
    EDGE_NSTEPS periods): PRN 7 after its first sample, PRN 13 before the
    latest start whose windows (``smax`` samples after their period
    start) fit in its tail over the first block's periods."""
    from gnsslib_tpu_torch.constants import DType
    from gnsslib_tpu_torch.runtime.receiver import block_geometry
    from gnsslib_tpu_torch.track import TrackConfig, Tracker
    trk = Tracker(TrackConfig(*CORR), [7], [1], F_SF, F_IF, DType.REAL,
                  device="cpu")
    nsamp = trk.n_nom
    blen = block_geometry(EDGE_NSTEPS, nsamp, trk.nwin)["block_len"]
    late = 1023.0 / (1.023e6 * (1.0 - EDGE_DOPPLER[13] / 1.57542e9)) * F_SF
    return {7: EDGE_B0 - nsamp + EDGE,
            13: EDGE_B0 + blen - int(np.ceil(EDGE_NSTEPS * late)) - trk.smax
            - EDGE}


def phase_edge(dev, capture: str, starts: dict) -> int:
    """Phase 12 (c): the repaired block edge on the card.  First the fixed
    block ([base - nsamp, base + block_len), the nominal rebase) must
    lose each channel within a few blocks (the band correlator's flag
    raises); then the receiver, with both channels started at those
    edges, locked and bit-synced, runs its replayed
    steady graphs to the end of the capture, far past that block, with
    every window inside its block and K1 flagging none.  Returns K1's
    launches in the receiver's run."""
    import torch
    from gnsslib_tpu_torch.constants import DType, FrontendType
    from gnsslib_tpu_torch.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime.config import (ChannelConfig,
                                                  ReceiverConfig)
    from gnsslib_tpu_torch.runtime.receiver import Receiver, block_geometry
    from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker

    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                        f_if=F_IF, dtype=DType.REAL)
    raised = {}
    for prn, dop in EDGE_DOPPLER.items():
        fe = FileFrontend(capture, spec)
        trk = Tracker(TrackConfig(*CORR), [prn], [1], F_SF, F_IF,
                      DType.REAL, device=dev)
        fast = FastTracker(trk)
        nsamp = trk.n_nom
        blen = block_geometry(EDGE_NSTEPS, nsamp, trk.nwin)["block_len"]
        base = EDGE_B0
        st = trk.start_channels(trk.init_state(), [0],
                                [starts[prn] - (base - nsamp)], [-dop])
        st = trk.set_bit_sync(st, 0, 0)
        for k in range(8):
            block = torch.from_numpy(np.ascontiguousarray(
                fe.read(base - nsamp, blen + nsamp))).to(dev)
            try:
                st, _ = fast.run_block(st, block, EDGE_NSTEPS)
            except RuntimeError as e:
                if "outside the sample block" not in str(e):
                    raise
                raised[prn] = k
                break
            st = trk.rebase(st, EDGE_NSTEPS * nsamp)
            base += EDGE_NSTEPS * nsamp
        fe.close()
    log(f"[12c] the fixed block (nominal rebase) raised at block "
        f"{raised} (PRN: block index; 7 +4 kHz of code Doppler at its head, "
        f"13 -4 kHz at its tail)")
    if sorted(raised) != sorted(EDGE_DOPPLER):
        raise AssertionError(f"the fixed block did not raise: {raised}")

    cfg = ReceiverConfig(channels=[ChannelConfig(prn=p)
                                   for p in EDGE_DOPPLER],
                         fends=[spec], files=[capture],
                         track=TrackConfig(*CORR), outms=400, rinex=False)
    fe = FileFrontend(capture, spec)
    rx = Receiver(cfg, fe, device=dev, nsteps_per_block=EDGE_NSTEPS)
    rx.base, rx.origin = EDGE_B0, EDGE_B0 - rx.lead
    for ch in rx.channels:
        dop = EDGE_DOPPLER[ch.cfg.prn]
        period = 1023.0 / (1.023e6 * (1.0 - dop / 1.57542e9)) * F_SF
        rx._start(ch.idx, starts[ch.cfg.prn] - EDGE_B0, -dop, period)
        rx.state = rx.trk.set_bit_sync(rx.state, ch.idx, 0)
        ch.locked = ch.synced = True
    blocks = []
    feed = rx._feed_nav_and_obs

    def record(out, cnt0, base, origin, locked0):
        starts_ = origin + out.loc.astype(np.int64)
        blocks.append((base, origin, int(starts_.min()),
                       int((starts_ + out.n).max()),
                       starts_[:, 0].min() < base - rx.nsamp,
                       (starts_[:, 1] + out.n[:, 1]).max()
                       > base + rx.block_len))
        feed(out, cnt0, base, origin, locked0)
    rx._feed_nav_and_obs = record
    bt.COUNTS.reset()
    stats = rx.run_seconds()
    launches, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    rx.close()
    fe.close()
    replays = sum(p.replays for p in rx.fast.programs.values())
    inside = all(o <= lo and hi <= o + rx.span
                 for _, o, lo, hi, *_ in blocks)
    early = sum(b[4] for b in blocks)
    late = sum(b[5] for b in blocks)
    drift = (blocks[-1][1] - blocks[1][1]
             - (len(blocks) - 2) * EDGE_NSTEPS * rx.nsamp)
    log(f"[12c] receiver: {len(blocks)} blocks of {EDGE_NSTEPS} periods "
        f"from {EDGE_B0 / F_SF:.1f} s, all through the replayed steady "
        f"graph ({replays} replays); windows inside their blocks: {inside}; "
        f"blocks with the early channel before the fixed block's first "
        f"sample {early}, with the late one past its tail {late}; from the "
        f"second block on the origin moved {drift:+d} samples against the "
        f"nominal cursor; band_taps launches "
        f"{launches}, v1 {v1}, plain {plain}; no out-of-band window")
    if (len(blocks) < max(raised.values()) + 3 or not inside or not early
            or not late or stats["locked"] != list(EDGE_DOPPLER)):
        raise AssertionError(f"edge run: {len(blocks)} blocks, inside "
                             f"{inside}, early {early}, late {late}, "
                             f"locked {stats['locked']}")
    if launches <= 0 or v1 != 0 or plain != 0 or replays != len(blocks):
        raise AssertionError(f"band_taps launches {launches}, v1 {v1}, "
                             f"plain {plain}, replays {replays}")
    return launches


@contextlib.contextmanager
def _cli_hooked(out: dict):
    """Inside the block, every CLI run of this process records into
    ``out``: the receiver it built (``rx``), the epochs it emitted, the
    run's wall (``run_s``) and, with ``--profile``, the profiler block's
    wall (run and trace writing); K1's counts are reset once the receiver
    is built (its programs' eager warm-ups launch K1 too).  On leaving,
    ``out["launches"]`` holds K1's launches since then."""
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime import cli
    out.update(rx=None, epochs=None, run_s=0.0, profiled_s=None)
    make, profiled = cli.build_receiver, cli._profiled

    def keep(*a, **kw):
        rx = out["rx"] = make(*a, **kw)
        out["epochs"] = _record(rx)
        run = rx.run_seconds

        def timed(*ra, **rkw):
            t0 = time.time()
            stats = run(*ra, **rkw)
            out["run_s"] = time.time() - t0
            return stats
        rx.run_seconds = timed
        bt.COUNTS.reset()
        return rx

    def timed_profile(*a, **kw):
        t0 = time.time()
        stats = profiled(*a, **kw)
        out["profiled_s"] = time.time() - t0
        return stats
    cli.build_receiver, cli._profiled = keep, timed_profile
    t0 = time.time()
    try:
        yield out
    finally:
        cli.build_receiver, cli._profiled = make, profiled
        out["wall"] = time.time() - t0
        out["launches"] = (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain)


def _cli_run(tag: str, argv: list) -> dict:
    """The CLI in this process on ``argv``: its exit code (``rc``) and
    what :func:`_cli_hooked` records (the receiver, the epochs, K1's
    launches during the run, the CLI's and the run's walls)."""
    from gnsslib_tpu_torch.runtime import cli
    with _cli_hooked({}) as out:
        out["rc"] = cli.main(argv)
    if out["rc"] != 0 or out["rx"] is None:
        raise AssertionError(f"[{tag}] CLI exit {out['rc']}")
    return out


def _k1_of(tag: str, dev, run: dict, steady: bool = True) -> int:
    """A run's K1 launches, checked on a card: every launch through the
    cluster kernel and, for a run that reached the steady state
    (``steady``), every one counted through the graph replays."""
    k1, v1, plain = run["launches"]
    if dev.type == "cuda":
        if steady:
            _receiver_programs(tag, run["rx"], k1)
        if v1 != 0 or plain != 0:
            raise AssertionError(f"[{tag}] band_taps v1 {v1}, plain {plain}")
    return k1


def _lobe_centre(freq, pdb, f_if: float) -> float:
    """Where the C/A signals' main lobe sits in a real-IF spectrum: the
    centre, on a 1 kHz grid within 0.5 MHz of ``f_if``, of the sinc^2 lobe
    (1.023 MHz half-width) that best matches the power above the noise
    floor (the median beyond 2.5 MHz of the IF).  At 47 dB-Hz the signals
    lie ~16 dB under the noise per sample and lift the spectrum ~0.4 dB
    around the IF, below one bin's scatter over 100 windows (~0.4 dB), so
    the spectrum's own argmax is a noise bin."""
    lin = 10.0 ** (np.asarray(pdb, np.float64) / 10.0)
    far = (np.abs(freq - f_if) > 2.5e6) & (freq > 0.3e6) & \
        (freq < freq[-1] - 0.3e6)
    excess = lin / np.median(lin[far]) - 1.0
    near = np.abs(freq - f_if) <= 2.0e6
    cands = f_if + np.arange(-500, 501) * 1e3
    score = [float((excess[near] * np.sinc((freq[near] - c) / 1.023e6)
                    ** 2).sum()) for c in cands]
    return float(cands[int(np.argmax(score))])


def _union(intervals) -> float:
    """The length covered by (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _busy_share(trace: dict, per_block: int) -> tuple:
    """The device's busy share from a torch.profiler trace: the union of
    its kernel intervals over the steady stage (first to last K1 launch)
    and, per steady block (``per_block`` consecutive K1 launches), over
    its span from its first to its last K1.  Returns (K1 events, the
    stage's share, the median block share, the blocks' shares' range,
    kernels in the trace)."""
    kern = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
            for e in trace.get("traceEvents", [])
            if e.get("cat") == "kernel" and "ts" in e]
    k1 = sorted((a, b) for a, b, n in kern if "band_taps" in n)
    if not k1:
        return 0, None, None, None, len(kern)
    iv = sorted((a, b) for a, b, _ in kern)

    def share(lo, hi):
        inside = [(max(a, lo), min(b, hi)) for a, b in iv
                  if b > lo and a < hi]
        return _union(inside) / max(hi - lo, 1e-9)
    stage = share(k1[0][0], k1[-1][1])
    blocks = [share(k1[i][0], k1[i + per_block - 1][1])
              for i in range(0, len(k1) - per_block + 1, per_block)]
    return (len(k1), stage, float(np.median(blocks)) if blocks else None,
            (min(blocks), max(blocks)) if blocks else None, len(kern))


def phase_diag(dev, capture: str, fe1: str, fe2: str, ref_events,
               ref_epochs, ref) -> int:
    """Phase 13, the diagnostics and the pipeline options at full width.
    (a) The CLI on phase 6's INI with ``--spec --watch-html``: the first
    second's spectrum and histogram, the live monitor (one frame per
    block), the HTML view, and phase 6's acquisition decisions, events and
    epochs bit for bit.  (c) Phase 6's receiver sequential against
    pipelined (bit for bit) and at pipeline depths 1 and 3 (their own
    spans), and phase 11's two front ends in a MultiReceiver with SPEC (one
    monitor per front end, FE2's I/Q spectrum).  (b) ``--profile`` for
    10 s beside the same run unprofiled: the trace, its K1 kernels and the
    device's busy share in the steady blocks.  Returns K1's launches in
    all of these runs."""
    import shutil
    from gnsslib_tpu_torch.io.frontend import FileFrontend
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import (Receiver,
                                                    block_geometry,
                                                    build_receiver)

    for d in ("diag", "diag_b0", "diag_b1", "modes"):
        shutil.rmtree(os.path.join(WORK, d), ignore_errors=True)
    total = 0

    # (a) the CLI with SPEC and the HTML view
    html = os.path.join(WORK, "diag", "live.html")
    os.makedirs(os.path.dirname(html), exist_ok=True)
    a = _cli_run("13a", [_write_ini(capture, "diag"), "--device", dev.type,
                         "--quiet", "--spec", "--watch-html", html])
    rx = a["rx"]
    total += _k1_of("13a", dev, a)
    from gnsslib_tpu_torch.diag import welch_spectrum
    npz = np.load(os.path.join(WORK, "diag", "rinex", "spectrum.npz"))
    peak = float(npz["freq"][np.argmax(npz["pdb"])])
    lobe = _lobe_centre(npz["freq"], npz["pdb"], F_IF)
    nhist = int(npz["counts"].sum())
    # the plain version: the same second through the same windows on the
    # CPU
    with open(capture, "rb") as f:
        first = np.frombuffer(f.read(int(F_SF)), np.int8).astype(np.float32)
    freq_c, pdb_c = welch_spectrum(first, F_SF, device="cpu")
    spec_err = float(np.abs(npz["pdb"] - pdb_c).max())
    mon = rx.spec_monitor
    blocks = rx.base // (rx.nsteps * rx.nsamp)
    page = open(html).read()
    taps = [p for p in TRUTH if f"PRN {p} taps @" in page]
    sw = rx.stage_wall
    log(f"[13a] CLI --spec --watch-html: {rx.base / F_SF:.1f} s of stream, "
        f"CLI wall {a['wall']:.1f} s, run {a['run_s']:.2f} s (phase 6's "
        f"run: {ref['wall']:.2f} s); steady stage {sw['steady']:.3f} s "
        f"against phase 6's {ref['stage_wall']['steady']:.3f} s (pull-in "
        f"{sw['pullin']:.3f} against {ref['stage_wall']['pullin']:.3f} s, "
        f"acquire {sw['acquire']:.3f} against "
        f"{ref['stage_wall']['acquire']:.3f} s)")
    log(f"[13a] spectrum.npz: the C/A main lobe centred at "
        f"{lobe / 1e6:.4f} MHz (IF {F_IF / 1e6:.3f}; the largest bin, a "
        f"noise bin, at {peak / 1e6:.4f} MHz), max {spec_err:.5f} dB from "
        f"the plain version on the CPU (tolerance 0.01), histogram of {nhist} "
        f"samples; the monitor made "
        f"{mon.nframes} frames in {blocks} blocks, "
        f"{1e3 * mon.seconds / max(mon.nframes, 1):.3f} ms per frame on its "
        f"own CUDA stream; the page ({len(page)} bytes) shows the taps of "
        f"PRNs {taps} and {page.count('acquisition @')} acquisition "
        f"surface (the newest); acquisition views held for "
        f"{sorted(rx.acq_views)}; K1 launches {a['launches'][0]}")
    if abs(lobe - F_IF) > 0.05e6 or nhist != int(F_SF) or \
            not np.array_equal(npz["freq"], freq_c) or spec_err > 0.01:
        raise AssertionError(f"spectrum lobe at {lobe}, {spec_err} dB from "
                             f"the plain version, histogram {nhist}")
    if abs(mon.nframes - blocks) > 1 or len(mon.frames) == 0:
        raise AssertionError(f"{mon.nframes} monitor frames, {blocks} blocks")
    if f"locked {len(TRUTH)}/{len(rx.channels)}" not in page or \
            sorted(taps) != sorted(TRUTH) or "acquisition @" not in page \
            or sorted(rx.acq_views) != sorted(TRUTH):
        raise AssertionError(f"HTML view: taps {taps}, acquisition views "
                             f"{sorted(rx.acq_views)}")
    if _decisions(rx) != ref["decisions"] or rx.events != ref_events or \
            a["epochs"] != ref_epochs:
        raise AssertionError(f"[13a] with SPEC: {len(rx.events)} events, "
                             f"{len(a['epochs'])} epochs: decisions, events "
                             f"or epochs differ from phase 6's")
    log(f"[13a] SPEC on: acquisition decisions of all {len(rx.channels)} "
        f"channels, {len(ref_events)} events and {len(ref_epochs)} epochs "
        f"equal phase 6's bit for bit")

    # (c) the pipeline modes on phase 6's receiver, and a MultiReceiver
    cfg = load_ini(_write_ini(capture, "modes"))
    cfg.rinex = False
    modes = (("sequential", dict(pipeline=False, pipeline_acq=False,
                                 pipeline_pullin=False)),
             ("pipelined", dict(pipeline=True, pipeline_acq=False,
                                pipeline_pullin=False)),
             ("depth 1", dict(pipeline_depth=1)),
             ("depth 3", dict(pipeline_depth=3)))
    runs = {}
    for name, kw in modes:
        fe = FileFrontend(cfg.files[0], cfg.fends[0])
        t0 = time.time()
        r = Receiver(cfg, fe, device=dev, nsteps_per_block=400, **kw)
        built = time.time() - t0
        epochs = _record(r)
        bt.COUNTS.reset()
        t0 = time.time()
        stats = r.run_seconds()
        wall = time.time() - t0
        run = dict(rx=r, launches=(bt.COUNTS.kernel, bt.COUNTS.v1,
                                   bt.COUNTS.plain))
        r.close()
        fe.close()
        total += _k1_of(f"13c {name}", dev, run)
        runs[name] = (r, epochs)
        s_ = stats["stage_wall"]
        log(f"[13c] {name} ({kw}): block {r.span} samples, built in "
            f"{built:.2f} s, run {wall:.2f} s (acquire {s_['acquire']:.3f}, "
            f"pull-in {s_['pullin']:.3f}, steady {s_['steady']:.3f} s); "
            f"{len(epochs)} epochs; K1 launches {run['launches'][0]}")
        by = {ch.cfg.prn: ch for ch in r.channels}
        if any(not (by[p].synced and by[p].nav.flagdec) for p in TRUTH) or \
                any(ch.locked for p, ch in by.items() if p not in TRUTH):
            raise AssertionError(f"[13c] {name}: locks {stats['locked']}, "
                                 f"decoded {stats['decoded']}")
        if _decisions(r) != ref["decisions"] or \
                [e for e in r.events if e[0] == "acq"] != \
                [e for e in ref_events if e[0] == "acq"]:
            raise AssertionError(f"[13c] {name}: acquisitions differ from "
                                 f"phase 6's")
        depth = kw.get("pipeline_depth", 2)
        span = block_geometry(400, r.nsamp, r.trk.nwin, depth)["span"]
        shapes = {k[-1] for k in r.trk.programs}
        if r.span != span or shapes != {(span,)}:
            raise AssertionError(f"[13c] {name}: span {r.span}, programs "
                                 f"{shapes}, expected {span}")
    (rs, es), (rp, ep) = runs["sequential"], runs["pipelined"]
    if rs.events != rp.events or es != ep or any(
            not np.array_equal(a.hist.tow, b.hist.tow)
            for a, b in zip(rs.channels, rp.channels)):
        raise AssertionError("[13c] pipeline=False differs from "
                             "pipeline=True")
    log(f"[13c] pipeline=False equals pipeline=True (both without pipelined "
        f"acquisition and pull-in): {len(rs.events)} events, {len(es)} "
        f"epochs and the observable TOWs bit for bit")

    mcfg = load_ini(_write_multi_ini(fe1, fe2, range(1, 33), MG_SBAS_PRNS,
                                     MG_G1_FCNS, 0, 0))
    mcfg.rinex = mcfg.rtcm = mcfg.sbas = False
    mcfg.spec = True
    fes = {ft: FileFrontend(mcfg.files[ft - 1], mcfg.fends[ft - 1])
           for ft in (1, 2)}
    t0 = time.time()
    mrx = build_receiver(mcfg, fes, device=dev, nsteps_per_block=400)
    built = time.time() - t0
    bt.COUNTS.reset()
    t0 = time.time()
    mrx.run_seconds(3.0)
    wall = time.time() - t0
    run = dict(rx=mrx, launches=(bt.COUNTS.kernel, bt.COUNTS.v1,
                                 bt.COUNTS.plain))
    mrx.close()
    for f in fes.values():
        f.close()
    # 3 s end in pull-in: no steady block, no K1 launch
    total += _k1_of("13c multi", dev, run, steady=False)
    groups = mrx.rx
    mons = [(g.spec.ftype, g.spec_monitor) for g in groups
            if g.spec_monitor is not None]
    nblk = groups[0].base // (groups[0].nsteps * groups[0].nsamp)
    log(f"[13c] MultiReceiver with SPEC, 3 s: {len(groups)} groups, "
        f"monitors on FE{[ft for ft, _ in mons]}, frames "
        f"{[m.nframes for _, m in mons]} in {nblk} blocks, "
        f"{[round(1e3 * m.seconds / max(m.nframes, 1), 3) for _, m in mons]}"
        f" ms per frame; built in {built:.2f} s, run {wall:.2f} s (wall by "
        f"phase per group "
        f"{[{k: round(v, 3) for k, v in g.stage_wall.items()} for g in groups]}"
        f"); K1 launches {run['launches'][0]}")
    if len(groups) != 3 or [ft for ft, _ in mons] != [1, 2] or any(
            abs(m.nframes - nblk) > 1 for _, m in mons):
        raise AssertionError(f"[13c] monitors {mons} for {len(groups)} "
                             f"groups")
    f2 = mons[1][1].latest
    if not (f2.freq_hz[0] == -F_SF / 2 and f2.freq_hz[-1] < F_SF / 2
            and np.all(np.diff(f2.freq_hz) > 0)
            and f2.pspec_db.shape == (16384,)
            and np.all(np.isfinite(f2.pspec_db))):
        raise AssertionError(f"[13c] FE2's spectrum axis {f2.freq_hz[:2]}"
                             f"..{f2.freq_hz[-1]}")
    log(f"[13c] FE2's I/Q spectrum over [{f2.freq_hz[0] / 1e6:.3f}, "
        f"{f2.freq_hz[-1] / 1e6:.3f}] MHz (fftshifted), peak "
        f"{f2.freq_hz[np.argmax(f2.pspec_db)] / 1e6:.4f} MHz")

    # (b) --profile, beside the same run unprofiled
    b0 = _cli_run("13b", [_write_ini(capture, "diag_b0"), "--device",
                          dev.type, "--quiet", "--seconds", "10"])
    total += _k1_of("13b unprofiled", dev, b0)
    prof = os.path.join(WORK, "diag_b1", "profile")
    b1 = _cli_run("13b", [_write_ini(capture, "diag_b1"), "--device",
                          dev.type, "--quiet", "--seconds", "10",
                          "--profile", prof])
    total += _k1_of("13b profiled", dev, b1)
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".json")]
    if len(traces) != 1:
        raise AssertionError(f"[13b] traces {traces}")
    mb = os.path.getsize(traces[0]) / 1e6
    t0 = time.time()
    with open(traces[0]) as f:
        trace = json.load(f)
    parse = time.time() - t0
    fast = b1["rx"].fast
    n1, stage, med, rng, nk = _busy_share(trace, b1["rx"].nsteps // fast.L)
    log(f"[13b] --profile --seconds 10: trace {mb:.1f} MB "
        f"({os.path.basename(traces[0])}), written in "
        f"{b1['profiled_s'] - b1['run_s']:.2f} s after the run, parsed in "
        f"{parse:.2f} s; {nk} kernels, {n1} of them K1 (counted launches "
        f"{b1['launches'][0]}); profiled run {b1['run_s']:.2f} s against "
        f"{b0['run_s']:.2f} s unprofiled (CLI walls {b1['wall']:.1f} and "
        f"{b0['wall']:.1f} s)")
    if not n1 or med is None:
        raise AssertionError(f"[13b] the trace names {n1} K1 kernels")
    log(f"[13b] device busy share (union of kernel intervals): "
        f"{100 * stage:.1f}% over the steady stage (first to last K1), "
        f"median {100 * med:.1f}% (range {100 * rng[0]:.1f}-"
        f"{100 * rng[1]:.1f}%) inside a steady block's K1 span")
    return total


def _k1_run(tag: str, dev, fn, *args, **kw):
    """``fn(*args, **kw)`` with the band_taps counters set to 0 just
    before and read just after: (fn's result, its K1 launches); on a card
    every launch must go to the cluster kernel."""
    from gnsslib_tpu_torch.ops import band_taps as bt
    bt.COUNTS.reset()
    out = fn(*args, **kw)
    k1, v1, plain = bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain
    if dev.type == "cuda" and (v1 or plain):
        raise AssertionError(f"[{tag}] band_taps v1 {v1}, plain {plain}")
    return out, k1


def _recorded(rxt, fn, *args, **kw):
    """``fn(*args, **kw)`` with every receiver that the tool module ``rxt``
    builds (its ``receiver``) recording its epochs (:func:`_record`):
    (fn's result, the epochs of the last receiver built)."""
    built, make = [], rxt.receiver

    def receiver(*a, **k):
        rx = make(*a, **k)
        built.append(_record(rx))
        return rx
    rxt.receiver = receiver
    try:
        out = fn(*args, **kw)
    finally:
        rxt.receiver = make
    return out, built[-1]


def phase_tools(dev) -> tuple:
    """Phase 14, the receiver tools (``gnsslib_tpu_torch.tools``) in
    process on the card at full width: (a) the tools' capture (written in
    phase 4), (e) K1 at 32-256 channels and held against its plain version
    at 256, (b) ttff resident and streamed, (c) the receiver's throughput
    pipelined and sequential at RX_NSTEPS-step blocks, the sequential run
    held against the pipelined receiver without acquisition and pull-in
    pipelining, (d) the receiver's stage table, (f) 256 channels in one
    receiver, (g) the acquisition grid, (h) the end-to-end check, (i)
    measure_round's acq child.  Returns the K1 launches of the receiver
    runs (b, c, d, f) and K1's largest error against its plain version at
    256 channels."""
    import glob
    import tempfile
    import torch
    from gnsslib_tpu_torch.tools import (acq_throughput, e2e_receiver_check,
                                         measure_round, profile_receiver,
                                         receiver_256ch, scaling_channels,
                                         ttff)
    from gnsslib_tpu_torch.tools import receiver_throughput as rxt
    from gnsslib_tpu_torch.track.program import CAPTURES
    t_phase = time.time()
    k1_main = 0

    # (a) the capture
    path = rxt.cache_path()
    n = os.path.getsize(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    if n != int(20 * rxt.F_SF) or meta != dict(
            f_sf=rxt.F_SF, f_if=rxt.F_IF, seconds=20.0, n=12):
        raise AssertionError(f"[14a] capture {path}: {n} bytes, {meta}")
    log(f"[14a] receiver_throughput's capture (phase 4): {path}, 20 s x 12 "
        f"satellites at {rxt.F_SF / 1e6:.3f} Msps int8 ({n} bytes)")

    # (e) K1 at full width: its device time gives the receiver's cap
    rows, k1_e = _k1_run("14e", dev, scaling_channels.run, device=dev)
    for r in rows:
        log(f"[14e] {scaling_channels.line(r)}; {r['windows']} windows per "
            f"super-step, first block {r['first_block_s']:.2f} s")
        if r["k1_launches"] != r["expected"]:
            raise AssertionError(f"[14e] C={r['C']}: K1 launches "
                                 f"{r['k1_launches']} != {r['expected']}")
    c32 = rows[0]
    cap = 10 * 16368 / (c32["ms_step_event"] * 1e-3) / 1e6
    log(f"[14e] K1 launches {k1_e} (= the super-steps run); the steady "
        f"super-step of 32 channels ({10 * 16368} samples) takes "
        f"{c32['ms_step_event']:.4f} ms of device time: a device cap of "
        f"{cap:.1f} Msamples/s")
    # K1 at the widest super-step, 256 channels x L windows, against its
    # plain version (the scaling tool runs on random samples)
    c256 = rows[-1]
    trk, host, _, _, _, errs, _ = hold_k1(
        dev, False, "14e", corr=scaling_channels.CORR,
        sf=scaling_channels.F_SF, fif=scaling_channels.F_IF,
        windows=c256["windows"] // c256["C"], channels=c256["C"])
    if c256["C"] != 256 or host[1].shape[0] != c256["windows"]:
        raise AssertionError(f"[14e] held K1 at {host[1].shape[0]} windows, "
                             f"the tool's widest row {c256}")
    err_e = max(errs.values())

    # (b) time to first fix, resident and streamed
    runs = {}
    for mode in ("resident", "stream"):
        r, k1 = _k1_run(f"14b {mode}", dev, ttff.run_once, time.time(),
                        device=dev, stream=mode == "stream")
        k1_main += k1
        runs[mode] = r
        tl = r["timeline"]
        missing = [m for m in ttff.MILESTONES if m not in tl]
        log(f"[14b] ttff {mode}: " + ", ".join(
            f"{k} {tl[k]:.2f}" for k in sorted(tl, key=tl.get))
            + f" s; build {r['build_s']:.2f} s (nvcc in this process: "
            f"{r['nvcc_s'] or 'none'}); run {r['run_wall_s']:.2f} s, "
            f"{r['msps_lifecycle']:.1f} Msamples/s over the run; stage "
            f"walls " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  r["stage_wall"].items())
            + f"; locked {r['locked']}, decoded {r['decoded']}, epochs "
            f"{r['epochs']}; K1 launches {k1}")
        if missing or r["locked"] != 12 or r["decoded"] != 12 or \
                r["epochs"] <= 0 or r["device"] != "cuda":
            raise AssertionError(f"[14b] {mode}: missing {missing}, {r}")
    if runs["stream"]["events"] != runs["resident"]["events"] or \
            runs["stream"]["epochs"] != runs["resident"]["epochs"]:
        raise AssertionError("[14b] the stream run differs from the "
                             "resident run")
    log(f"[14b] stream equals resident: {len(runs['stream']['events'])} "
        f"events and {runs['stream']['epochs']} epochs bit for bit")

    # (c) receiver throughput pipelined and sequential at the tool's
    # 400-step configuration (RX_NSTEPS), whose 20 s run has enough steady
    # blocks for the median
    thr = {}
    nsteps = RX_NSTEPS
    for pipeline in (True, False):
        (s, epochs), k1 = _k1_run("14c", dev, _recorded, rxt, rxt.run,
                                  pipeline, nsteps, 2, device=dev)
        k1_main += k1
        thr[pipeline] = s
        s["recorded"] = epochs
        log(f"[14c] {rxt.line(s)}; K1 launches {k1}; stage walls "
            + ", ".join(f"{k} {v:.3f}" for k, v in s["stage_wall"].items()))
        p50 = s.get("msps_steady_p50")
        log(f"[14c] {s['label']}: msps {s['msps']:.1f}, msps_steady "
            f"{s.get('msps_steady', 0.0):.1f}, msps_steady_p50 "
            + (f"{p50:.1f}" if p50 else "none (fewer than 8 steady blocks)")
            + f" over {s['n_steady_blocks']} steady blocks, against the "
            f"device cap {cap:.1f} Msamples/s (14e)")
        if len(s["locked"]) != 12 or s["device"] != "cuda":
            raise AssertionError(f"[14c] {s['label']}: locked {s['locked']}")
    ev_p, ev_s = thr[True]["events"], thr[False]["events"]
    acq_p = [e for e in ev_p if e[0] == "acq"]
    acq_s = [e for e in ev_s if e[0] == "acq"]
    if acq_p != acq_s or sorted(thr[True]["decoded"]) != \
            sorted(thr[False]["decoded"]):
        raise AssertionError("[14c] the modes' acquisitions or decodes "
                             "differ")
    nav_p = [e for e in ev_p if e[0] != "acq"]
    nav_s = [e for e in ev_s if e[0] != "acq"]
    differ = [(a, b) for a, b in zip(nav_p, nav_s) if a != b]
    log(f"[14c] pipelined against sequential: {len(acq_p)} acquisitions "
        f"equal bit for bit; nav events {len(nav_p)} and {len(nav_s)}, "
        f"{len(differ)} differ" + (f" (first: {differ[0][0]} against "
                                    f"{differ[0][1]})" if differ else "")
        + f"; epochs {thr[True]['epochs']} and "
        f"{thr[False]['epochs']} (the sequential mode decides its "
        f"searches at once, the pipelined one 2 blocks later)")
    # the same timing in both modes: the pipelined receiver with its
    # searches and pull-in unpipelined gives the sequential run's bits
    seq = thr[False]
    with tempfile.TemporaryDirectory(dir=WORK) as d:
        rx = rxt.receiver(rxt.default_capture(), device=dev, rinexdir=d,
                          pipeline=True, pipeline_acq=False,
                          pipeline_pullin=False, nsteps_per_block=nsteps,
                          pipeline_depth=2)
        epochs = _record(rx)
        s, k1 = _k1_run("14c", dev, rx.run_seconds)
        rxt.close(rx)
    k1_main += k1
    log(f"[14c] pipelined/{nsteps}/d2 without acquisition and pull-in "
        f"pipelining: {s['msps']:.1f} Msamples/s, {len(rx.events)} events, "
        f"{len(epochs)} epochs (RINEX {s['epochs']}); K1 launches {k1}")
    if rx.events != seq["events"] or epochs != seq["recorded"] or \
            s["epochs"] != seq["epochs"] or s["decoded"] != seq["decoded"]:
        raise AssertionError("[14c] the pipelined receiver without "
                             "acquisition and pull-in pipelining differs "
                             "from the sequential run")
    log(f"[14c] it equals the sequential run bit for bit: "
        f"{len(seq['events'])} events and {len(seq['recorded'])} epochs")

    # (d) the receiver's stage table
    (s, T, total), k1 = _k1_run("14d", dev, profile_receiver.profile, True,
                                400, device=dev)
    k1_main += k1
    log(f"[14d] profile_receiver pipelined/400: {total:.2f} s for "
        f"{s['seconds']:.1f} s of signal ({s['msps']:.1f} Msamples/s), "
        f"two passes' K1 launches {k1}; stage walls "
        + ", ".join(f"{k} {v:.3f}" for k, v in s["stage_wall"].items()))
    for ln in profile_receiver.table(T):
        log(f"[14d] {ln}")
    log("[14d] (*.dispatch is launch time: a replayed graph returns at "
        "once; the device time lands in *.collect)")

    # (f) 256 channels in one receiver
    n0 = CAPTURES.captures
    out, k1 = _k1_run("14f", dev, receiver_256ch.run, device=dev)
    k1_main += k1
    out.pop("events")
    log(f"[14f] receiver_256ch: {json.dumps(out)}; K1 launches {k1}")
    if out["locked"] != 96 or out["channels"] != 256:
        raise AssertionError(f"[14f] locked {out['locked']} of "
                             f"{out['channels']}")
    log(f"[14f] 256 channels: {out['locked']} locked, {out['decoded']} "
        f"decoded, steady p50 {out.get('msps_steady_p50')} Msamples/s, "
        f"graph pool {out['graph_pool_mb']} MB ({out['captures']} captures "
        f"of the timed pass; {CAPTURES.captures - n0} in both), peak "
        f"reserved {out['peak_reserved_gb']} GB")

    # (g) the acquisition grid
    r, _ = _k1_run("14g", dev, acq_throughput.run, device=dev)
    log(f"[14g] acq_throughput: {json.dumps(r)}")
    if r["bins"] != 22720 or r["acquired"] != list(range(1, 9)):
        raise AssertionError(f"[14g] {r}")
    log(f"[14g] {r['seconds_per_search'] * 1e3:.2f} ms per 32-channel "
        f"search by the host clock, {r['device_seconds_per_search'] * 1e3:.2f}"
        f" ms by CUDA events: {r['value']:.0f} bins/s")

    # (h) the end-to-end check (the per-period tracker: no K1)
    r, k1 = _k1_run("14h", dev, e2e_receiver_check.run, device=dev)
    log(f"[14h] e2e_receiver_check.run(): E2E PASS in {r['wall']:.1f} s of "
        f"tracking for {r['done'] / 1000:.1f} s of signal, {r['captures']} "
        f"capture, K1 launches {k1}")

    # (i) measure_round's acq child, the artifact under a temporary dir
    pattern = os.path.join(ROOT, "MEASUREMENTS_torch_r*.json")
    before = sorted(glob.glob(pattern))
    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as d:
        out_path = os.path.join(d, "MEASUREMENTS_torch_smoke.json")
        rc = measure_round.main(["--skip", "bench,receiver,ttff",
                                 "--out", out_path])
        with open(out_path) as f:
            art = json.load(f)
    acq = art.get("acq") or {}
    if rc != 0 or acq.get("device") != "cuda" or acq.get("attempts") != 1 \
            or art.get("bench", 0) is not None or \
            sorted(glob.glob(pattern)) != before:
        raise AssertionError(f"[14i] measure_round rc {rc}: {art}")
    log(f"[14i] measure_round --skip bench,receiver,ttff: the acq child on "
        f"{acq['device']} at attempt {acq['attempts']} ({acq['wall_s']} s), "
        f"{acq['value']:.0f} bins/s; bench recorded absent; written only "
        f"under the temporary directory")
    log(f"[14] K1 launches of the receiver runs (b, c, d, f): {k1_main}; "
        f"the scaling tool's (e): {k1_e}; phase 14 in "
        f"{time.time() - t_phase:.1f} s ({card_line()})")
    return k1_main, err_e


# --------------------------------------------------------------------- #
# phase 15, the multi-device layer
P15_SHARDS = 4
P15_STEPS = 100          # periods per engine block (10 steady super-steps)


def _first_diff(a, b):
    """The first field in which two TrackOutputs differ bit for bit (None
    when they are equal)."""
    for f in a.__dataclass_fields__:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            return f
    return None


def _held15(tag: str, got, ref) -> bool:
    """Sharded telemetry ``got`` against the unsharded ``ref``: bit for
    bit, or the first differing field named and the fallback held (loc
    exact, test_fast.py's ip/qp bound, dcarr within 0.5 Hz)."""
    f = _first_diff(got, ref)
    if f is None:
        log(f"[{tag}] sharded == unsharded bit for bit")
        return True
    d = float(np.max(np.abs(np.asarray(getattr(got, f), np.float64)
                            - np.asarray(getattr(ref, f), np.float64))))
    log(f"[{tag}] sharded differs from unsharded: first field {f} (max "
        f"abs diff {d:.4g}); holding the fallback bound")
    if not np.array_equal(got.loc, ref.loc):
        raise AssertionError(f"[{tag}] loc differs")
    scale = float(np.max(np.abs(ref.ip)))
    for name in ("ip", "qp"):
        dd = np.abs(getattr(got, name) - getattr(ref, name))
        if int(np.sum(dd > 5e-3 * scale)) > 3 or \
                float(np.median(dd)) >= 1e-3 * scale:
            raise AssertionError(f"[{tag}] {name} beyond the bound")
    if float(np.max(np.abs(got.dcarr - ref.dcarr))) > 0.5:
        raise AssertionError(f"[{tag}] dcarr beyond 0.5 Hz")
    return False


def _shard_pools(tag: str, eng) -> None:
    """Log each shard's block programs: count and pool memory."""
    log(f"[{tag}] shard programs: " + "; ".join(
        f"channels {a}-{b - 1}: {len(e.programs)} programs, pool "
        f"{sum(p.pool_bytes for p in e.programs.values()) / 1e6:.1f} MB"
        for a, b, e in eng.shards))


def _shard_k1(eng) -> int:
    """K1 launches counted through every shard's program replays."""
    return sum(p.replays * p.launches.get("band_taps", {}).get("kernel", 0)
               for _, _, e in eng.shards for p in e.programs.values())


def _engines15(dev, mesh, block, nch: int) -> int:
    """(b) for ``nch`` channels (PRNs 1-nch; the TRUTH PRNs among them at
    their true code phase and Doppler, the others on noise): the pull-in
    block, then the band backend with two blocks in flight collected in
    order, then one block each of pallas (K3) and fused (K2), sharded over
    ``mesh`` against the unsharded engines from one state.  Returns the
    band blocks' K1 launches (counted through the shards' replays)."""
    import torch
    from gnsslib_tpu_torch.constants import CodeType, DType
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.ops import gram_taps, window_taps
    from gnsslib_tpu_torch.parallel import ShardedFastTracker, ShardedTracker
    from gnsslib_tpu_torch.track import FastTracker, TrackConfig, Tracker
    nn = int(round(F_SF / 1000))
    prns = list(range(1, nch + 1))
    trk = Tracker(TrackConfig(*CORR), prns, [CodeType.L1CA] * nch, F_SF,
                  F_IF, DType.REAL, device=dev)
    loc = [TRUTH[p][0] if p in TRUTH else (37 * p) % nn for p in prns]
    dcarr = [-TRUTH[p][1] if p in TRUTH else 0.0 for p in prns]
    st0 = trk.start_channels(trk.init_state(), list(range(nch)), loc, dcarr)
    tag = f"15b {nch}ch"
    strk = ShardedTracker(trk, mesh)
    log(f"[{tag}] shards {[(a, b - a) for a, b, _ in strk.shards]} on "
        f"{sorted({str(e.device) for _, _, e in strk.shards})}")
    ss, so = strk.run_block(st0, block, P15_STEPS)
    us, uo = trk.run_block(st0, block, P15_STEPS)
    _held15(f"{tag} pull-in", so, uo)
    st = trk.rebase(us, P15_STEPS * nn)
    for c in range(nch):
        st = trk.set_bit_sync(st, c, 0)
    fast = FastTracker(trk)
    sfast = ShardedFastTracker(fast, mesh)
    # the programs first: their eager warm-ups launch K1 too
    sfast.program(P15_STEPS, block.shape)
    bt.COUNTS.reset()
    s1, h1 = sfast.run_block_start(st, block, P15_STEPS)
    s2, h2 = sfast.run_block_start(trk.rebase(s1, P15_STEPS * nn), block,
                                   P15_STEPS)
    o1, o2 = sfast.run_block_collect(h1), sfast.run_block_collect(h2)
    cuda = dev.type == "cuda"
    # (a CPU rehearsal counts the plain version, and replays no graph)
    k1 = bt.COUNTS.kernel if cuda else bt.COUNTS.plain
    if (cuda and (_shard_k1(sfast) != k1 or bt.COUNTS.v1
                  or bt.COUNTS.plain)) or \
            k1 != len(sfast.shards) * 2 * (P15_STEPS // fast.L):
        raise AssertionError(f"[{tag}] band K1 launches {k1}, through the "
                             f"replays {_shard_k1(sfast)}, v1 "
                             f"{bt.COUNTS.v1}, plain {bt.COUNTS.plain}")
    u1, g1 = fast.run_block(st, block, P15_STEPS)
    u2, g2 = fast.run_block(trk.rebase(u1, P15_STEPS * nn), block,
                            P15_STEPS)
    _held15(f"{tag} band block 1 (two in flight)", o1, g1)
    _held15(f"{tag} band block 2", o2, g2)
    for corr, counts in (("pallas", window_taps.COUNTS16),
                         ("fused", gram_taps.COUNTS)):
        fast.corr = corr
        sfast.program(P15_STEPS, block.shape)
        counts.reset()
        _, o = sfast.run_block(st, block, P15_STEPS)
        n_k = counts.kernel if cuda else counts.plain
        _, g = fast.run_block(st, block, P15_STEPS)
        if n_k != len(sfast.shards) * (P15_STEPS // fast.L) or \
                (cuda and counts.plain):
            raise AssertionError(f"[{tag}] {corr}: {n_k} launches, "
                                 f"{counts.plain} plain")
        _held15(f"{tag} {corr} (launches {n_k})", o, g)
    fast.corr = "band"
    _shard_pools(f"{tag} pull-in", strk)
    _shard_pools(f"{tag} steady", sfast)
    return k1


def _acq15(dev, mesh, block) -> None:
    """(b) the sharded acquirer on the card: channel mode (32 channels on 4
    shards) and freq mode (2 channels on 4 shards) against the unsharded
    search on the same device block."""
    from gnsslib_tpu_torch.acquire import Acquirer
    from gnsslib_tpu_torch.constants import CodeType, DType
    from gnsslib_tpu_torch.parallel import ShardedAcquirer
    for prns in (list(range(1, 33)), [3, 11]):
        acq = Acquirer(prns, [CodeType.L1CA] * len(prns), F_SF, F_IF,
                       DType.REAL, device=dev)
        sacq = ShardedAcquirer(acq, mesh)
        t0 = time.time()
        a = sacq.search_dev(block)
        t1 = time.time()
        b = acq.search_dev(block)
        same = all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
            "codei", "freqi", "cn0", "peakr", "acquired", "confirmed"))
        rel = float(np.max(np.abs(a.cn0 - b.cn0) / np.abs(b.cn0)))
        log(f"[15b] ShardedAcquirer {sacq.mode} mode, {len(prns)} channels "
            f"on {mesh.size} shards ({len(sacq.shards)} used): "
            f"{(t1 - t0) * 1e3:.1f} ms; acquired "
            f"{[p for p, ok in zip(prns, a.acquired) if ok]}; bit for bit "
            f"{'yes' if same else 'no'}, cn0 max rel diff {rel:.3g}")
        if not (np.array_equal(a.codei, b.codei)
                and np.array_equal(a.freqi, b.freqi)
                and np.array_equal(a.acquired, b.acquired) and rel <= 1e-4):
            raise AssertionError(f"[15b] ShardedAcquirer {sacq.mode} differs")
        if sorted(p for p, ok in zip(prns, a.acquired) if ok) != \
                sorted(p for p in prns if p in TRUTH):
            raise AssertionError(f"[15b] acquired {a.acquired}")


def _rinex_body(path: str) -> list:
    """A RINEX file's lines but for the header line with the run's date."""
    with open(path) as f:
        return [ln for ln in f if "PGM / RUN BY / DATE" not in ln]


def _receiver15(dev, mesh, capture: str) -> tuple:
    """(c) phase 6's capture and INI with 4 shards against the unsharded
    receiver with ``pipeline_acq=False``; returns (the mesh run's K1
    launches, its wall, the unsharded run's wall)."""
    import shutil
    from gnsslib_tpu_torch.io.frontend import FileFrontend
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.runtime.config import load_ini
    from gnsslib_tpu_torch.runtime.receiver import Receiver
    runs = {}
    for name, kw in (("mesh15", dict(mesh=mesh)),
                     ("flat15", dict(pipeline_acq=False))):
        shutil.rmtree(os.path.join(WORK, name), ignore_errors=True)
        cfg = load_ini(_write_ini(capture, name=name))
        fe = FileFrontend(cfg.files[0], cfg.fends[0])
        t0 = time.time()
        rx = Receiver(cfg, fe, device=dev, nsteps_per_block=400, **kw)
        build = time.time() - t0
        epochs = _record(rx)
        bt.COUNTS.reset()
        t0 = time.time()
        stats = rx.run_seconds()
        rx.close()
        fe.close()
        wall = time.time() - t0
        k1 = (bt.COUNTS.kernel, bt.COUNTS.v1, bt.COUNTS.plain)
        if dev.type != "cuda":              # a CPU rehearsal
            k1 = (k1[2], 0, 0)
        runs[name] = (rx, epochs, k1, wall)
        sw = stats["stage_wall"]
        log(f"[15c] {name}: built in {build:.2f} s, {stats['seconds']:.1f} "
            f"s of stream in {wall:.2f} s (acquire {sw['acquire']:.2f}, "
            f"pull-in {sw['pullin']:.2f}, steady {sw['steady']:.2f} s); "
            f"locked {stats['locked']}, decoded {stats['decoded']}, "
            f"{stats['epochs']} epochs; K1 launches {k1[0]} (v1 {k1[1]}, "
            f"plain {k1[2]})")
    (rm, em, km, wm), (rs, es, ks, ws) = runs["mesh15"], runs["flat15"]
    _shard_pools("15c pull-in", rm._slow_eng)
    _shard_pools("15c steady", rm._fast_eng)
    counted = (_shard_k1(rm._fast_eng) + _shard_k1(rm._slow_eng)
               if dev.type == "cuda" else km[0])
    steady = sum(p.replays * p.count for p in rs.fast.programs.values())
    log(f"[15c] K1: mesh {km[0]} (through the shards' replays {counted}), "
        f"unsharded {ks[0]} = its {steady} steady super-steps; "
        f"{len(rm._fast_eng.shards)} x {ks[0]} = "
        f"{len(rm._fast_eng.shards) * ks[0]}")
    if km[1:] != (0, 0) or km[0] != counted or \
            km[0] != len(rm._fast_eng.shards) * ks[0] or ks[0] != steady:
        raise AssertionError(f"[15c] K1 launches mesh {km}, counted "
                             f"{counted}, unsharded {ks}, super-steps "
                             f"{steady}")
    same = dict(
        decisions=_decisions(rm) == _decisions(rs),
        events=rm.events == rs.events, epochs=em == es,
        rinex=all(_rinex_body(getattr(rm, w).path)
                  == _rinex_body(getattr(rs, w).path)
                  for w in ("obs_writer", "nav_writer")))
    log(f"[15c] mesh against unsharded (pipeline_acq=False), bit for bit: "
        + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in same.items())
        + f" ({len(rm.events)} events, {len(em)} epochs)")
    if not all(same.values()):
        if [e[:3] for e in rm.events] != [e[:3] for e in rs.events] or \
                not same["decisions"] or len(em) != len(es):
            raise AssertionError(f"[15c] the mesh receiver differs: {same}")
        dP = [abs(a[2] - b[2]) for ea, eb in zip(em, es)
              for a, b in zip(ea, eb)]
        log(f"[15c] fallback: events, decisions and epoch count equal; "
            f"pseudoranges max diff {max(dP):.3f} m, median "
            f"{float(np.median(dP)):.3f} m")
        if max(dP) > 10.0 or float(np.median(dP)) > 0.5:
            raise AssertionError("[15c] pseudoranges beyond the bound")
    if not rm.obs_writer or len(em) < 10:
        raise AssertionError(f"[15c] {len(em)} epochs")
    return km[0], wm, ws


def _cli15(dev, capture: str, ref_events, ref_epochs) -> int:
    """(d) ``--devices 1`` against phase 6's run (the receiver the CLI
    builds without the flag), and ``--devices 2``: refused with the JAX
    message on a one-card machine, else run and compared.  Returns the
    K1 launches of the CLI runs."""
    import io
    import torch
    from gnsslib_tpu_torch.runtime import cli
    k1 = 0
    ini = _write_ini(capture, name="dev1")
    run = _cli_run("15d", [ini, "--device", "cuda", "--quiet", "--devices",
                           "1"])
    k1 += _k1_of("15d", dev, run)
    if run["rx"].events != ref_events or run["epochs"] != ref_epochs:
        raise AssertionError("[15d] --devices 1 differs from phase 6")
    log(f"[15d] --devices 1: {run['run_s']:.2f} s, events and epochs equal "
        f"phase 6's bit for bit; K1 launches {run['launches'][0]}")
    cards = torch.cuda.device_count()
    ini2 = _write_ini(capture, name="dev2")
    if cards < 2:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main([ini2, "--device", "cuda", "--quiet", "--devices",
                           "2"])
        msg = err.getvalue().strip()
        log(f"[15d] --devices 2 on {cards} card: exit {rc}, {msg!r}")
        if rc == 0 or f"need 2 devices, have {cards}" not in msg:
            raise AssertionError(f"[15d] --devices 2: exit {rc}, {msg!r}")
    else:
        run = _cli_run("15d", [ini2, "--device", "cuda", "--quiet",
                               "--devices", "2"])
        k1 += run["launches"][0]
        same = run["rx"].events == ref_events and \
            run["epochs"] == ref_epochs
        log(f"[15d] --devices 2 on {cards} cards: {run['run_s']:.2f} s, "
            f"equal to phase 6 bit for bit: {'yes' if same else 'no'}")
        if not same:
            raise AssertionError("[15d] --devices 2 differs from phase 6")
    return k1


def _demos15(dev, mh_capture: str) -> int:
    """(e) both multi-process demos with two processes sharing the card
    over gloo.  Returns the receiver demo's K1 launches (both processes)."""
    import tempfile
    from gnsslib_tpu_torch.tools import multihost_demo
    from gnsslib_tpu_torch.tools import multihost_receiver_demo as mh
    t0 = time.time()
    res = multihost_demo.launch(device="cuda")
    out = "".join(o for _, o in res)
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    log(f"[15e] multihost_demo: exit codes {[rc for rc, _ in res]} in "
        f"{time.time() - t0:.1f} s; " + "; ".join(
            f"process {r['pid']}: {r['shards']} shards on {r['device']}, K1 "
            f"{r['k1_launches']} (plain {r['k1_plain']}), {r['wall']:.2f} s"
            for r in recs))
    line = [ln for ln in out.splitlines() if "MULTIHOST OK" in ln]
    # each shard's steady program: its eager warm-up's launch and its
    # replay's
    if any(rc for rc, _ in res) or not line or len(recs) != 2 or any(
            r["k1_launches"] != 2 * r["shards"] or r["k1_plain"]
            for r in recs):
        raise AssertionError(f"[15e] multihost_demo: {res}")
    log(f"[15e] {line[0]}")
    os.makedirs(WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as d:
        t0 = time.time()
        res = mh.launch(d, device="cuda", capture=mh_capture)
        wall = time.time() - t0
        obs = mh.check(res, d)
        written = sorted(os.listdir(d))
    rx = mh.receiver(mh_capture, dev, None, pipeline_acq=False)
    rx.run_seconds()
    rx.close()
    ref = mh.summary(rx)
    k1 = [r["k1_launches"] for r in res]
    log(f"[15e] multihost_receiver_demo: 2 processes x {mh.PER_PROCESS} "
        f"shards on {res[0]['device']} in {wall:.1f} s (per process "
        f"{[round(r['wall'], 2) for r in res]} s); locked "
        f"{res[0]['locked']}, decoded {res[0]['decoded']}, "
        f"{res[0]['epochs']} epochs; K1 per process {k1} (plain "
        f"{[r['k1_plain'] for r in res]}); files {written}")
    if any(r["k1_plain"] for r in res) or min(k1) <= 0 or \
            [p for p in written if p.endswith((".obs", ".nav"))] != \
            sorted([obs, obs[:-3] + "nav"]):
        raise AssertionError(f"[15e] K1 {k1}, files {written}")
    same = res[0]["events"] == ref["events"] and \
        res[0]["epochs"] == ref["epochs"]
    log(f"[15e] both processes' events equal each other; against a "
        f"single-process receiver (pipeline_acq=False) on the same "
        f"capture: bit for bit {'yes' if same else 'no'} "
        f"({len(ref['events'])} events, {ref['epochs']} epochs) "
        f"-> MULTIHOST RECEIVER OK")
    if not same:
        raise AssertionError("[15e] the demo differs from the "
                             "single-process receiver")
    return sum(k1)


def phase_parallel(dev, capture: str, mh_capture: str, ref_events,
                   ref_epochs) -> tuple:
    """Phase 15, the multi-device layer (``gnsslib_tpu_torch.parallel``) on
    one card: (a) K1 at the shard shapes (8 and 3 channels: 80 and 30
    windows) against its plain version, (b) the sharded engines on 4
    shards of the card against the unsharded ones from one state (32 and
    13 channels; pull-in, band with two blocks in flight, pallas, fused;
    the acquirer in channel and freq mode), (c) phase 6's receiver over
    the 4 shards against the unsharded receiver with
    ``pipeline_acq=False``, (d) the CLI's ``--devices``, (e) both
    multi-process demos with two processes on the card, (f)
    ``scaling_efficiency``.  Returns the K1 launches of the receiver runs
    (c, d, e) and K1's largest error against its plain version in (a)."""
    import gc
    import torch
    from gnsslib_tpu_torch.parallel import make_mesh
    from gnsslib_tpu_torch.tools import scaling_efficiency
    t_phase = time.time()
    # (a) K1 at the shard shapes
    err_a = 0.0
    for nch in (8, 3):
        _, host, _, _, _, errs, _ = hold_k1(dev, False, "15a", channels=nch)
        if host[1].shape[0] != nch * 10:
            raise AssertionError(f"[15a] {host[1].shape[0]} windows")
        err_a = max(err_a, max(errs.values()))
    # (b) the engines on 4 shards of the card
    mesh = make_mesh(devices=[dev] * P15_SHARDS)
    log(f"[15b] mesh {mesh}")
    nn = int(round(F_SF / 1000))
    x = np.fromfile(capture, np.int8, count=(P15_STEPS + 4) * nn + 32768)
    block = torch.from_numpy(x.astype(np.float32)).to(dev)
    for nch in (32, 13):
        _engines15(dev, mesh, block, nch)
        gc.collect()
        torch.cuda.empty_cache()
    _acq15(dev, mesh, block)
    del block
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the receiver over the mesh
    k1_c, wall_m, wall_s = _receiver15(dev, mesh, capture)
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the CLI
    k1_d = _cli15(dev, capture, ref_events, ref_epochs)
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the multi-process demos
    k1_e = _demos15(dev, mh_capture)
    # (f) scaling efficiency, all processes on the one card
    t0 = time.time()
    rec = scaling_efficiency.run(device="cuda")
    log(f"[15f] scaling_efficiency in {time.time() - t0:.1f} s: "
        f"{json.dumps(rec)} ({card_line()})")
    if not rec["efficiency"] > 0 or rec["k1_launches"][0] <= 0:
        raise AssertionError(f"[15f] {rec}")
    log(f"[15] K1 launches of the receiver runs: mesh receiver (c) {k1_c}, "
        f"CLI (d) {k1_d}, receiver demo (e) {k1_e}; mesh receiver "
        f"{wall_m:.2f} s against the unsharded {wall_s:.2f} s; phase 15 in "
        f"{time.time() - t_phase:.1f} s ({card_line()})")
    return k1_c + k1_d + k1_e, err_a


def _sbas_expected(seconds: float) -> list:
    """(29-byte payload, message id) of every SBAS message the parity
    tool's ``sbas`` capture carries, in order (message k fills second k
    of the stream)."""
    from gnsslib_tpu_torch.nav.sbas import (SbasMsg, decode_l1sbas_bits,
                                            gen_novatel_sbasmsg)
    from gnsslib_tpu_torch.tools import parity_vs_reference as pvr
    out = []
    for msg in pvr.sbas_messages(seconds):
        sb = SbasMsg(week=2200, tow=TOW0)
        decode_l1sbas_bits(msg, 1, sb, ref_week=2200)
        gen_novatel_sbasmsg(sb)
        (payload, mid, _), = pvr.parse_novatel_sbas(bytes(sb.novatelmsg))
        out.append((payload, mid))
    return out


def _parity_truth(kind: str) -> dict:
    """RINEX satellite id -> (Doppler at the capture's start (Hz), ramp
    (Hz/s), carrier wavelength (m)) of phase 16's capture ``kind``, in
    the RINEX convention: D is the signal's Doppler as ``sim`` defines it
    (the LO offset of ``ppm`` removed by PPMERR, a G1 channel's FDMA
    offset by its frequency number)."""
    from gnsslib_tpu_torch.constants import (CLIGHT, CodeType, DFRQ1_GLO,
                                             FREQ1_GLO)
    from gnsslib_tpu_torch.tools import parity_vs_reference as pvr
    chans = parity_signal(kind)[0]
    g1 = [c for c in chans if c.ctype == CodeType.G1]
    # the G1 slots the captures broadcast (string 4), in channel order
    slots = {"par_glo": [13],
             "par_fullenv_glo": [11 + i for i in
                                 range(len(pvr.FULLENVGLO_FCNS))]}
    out = {}
    for c in chans:
        if c.ctype == CodeType.G1:
            sid = ("R", slots[kind][g1.index(c)])
            lam = CLIGHT / (FREQ1_GLO + DFRQ1_GLO * c.prn)
        else:
            sid = ("S" if c.ctype == CodeType.L1SBAS else "G",
                   c.prn % 100)
            lam = CLIGHT / 1.57542e9
        out[sid] = (c.doppler, c.doppler_rate, lam)
    return out


def parity_run(dev, kind: str, path: str, corr=None, tag: str = "16"
               ) -> int:
    """One run of phase 16: capture ``kind`` (``path``) through
    ``parity_vs_reference.run_mine`` and its checks (see
    :func:`phase_parity`); with ``corr`` (CORRN, CORRD, CORRP) in place of
    the scenario's correlator (phase 17), and then every steady block's
    program launching K1 once per super-step.  Returns its K1 launches."""
    import shutil
    from gnsslib_tpu_torch.tools import parity_vs_reference as pvr
    scen = "highdyn" if kind == "ramp" else kind[len("par_"):]
    spec = pvr.SCENARIOS[scen]
    _, seconds, f_sf = parity_signal(kind)[:3]
    truth = _parity_truth(kind)
    work = os.path.join(WORK, "parity", kind + ("" if corr is None else
                                                "_%d_%d_%d" % corr))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with _cli_hooked({}) as run:
        obs, frames = pvr.run_mine(work, path, scen, dev.type, corr=corr)
    rx = run["rx"]
    k1 = _k1_of(f"{tag} {kind}", dev, run)
    if corr is not None:
        T = 2 * corr[0] + 1
        for g in getattr(rx, "rx", [rx]):
            for p in g.fast.programs.values():      # count: super-steps
                per = p.launches.get("band_taps", {}).get("kernel", 0)
                if len(g.fast.offsets) != T or (
                        dev.type == "cuda" and per != p.count):
                    raise AssertionError(
                        f"[{tag}] {kind}: {len(g.fast.offsets)} taps, a "
                        f"steady program of {p.count} super-steps "
                        f"launches K1 {per} times")
        log(f"[{tag}] {kind} at CORRN/CORRD/CORRP {corr}: {T} taps, each "
            f"steady block's program one K1 launch per super-step")
    # weak sits ~2 dB above the acquisition threshold: there a satellite
    # misses its first subframe within the capture in some noise draws,
    # in both packages alike; it is held to the parity tool's weak gate
    # (every satellite locked, its observation count, one decoded)
    decoded = [c.cfg.prn for c in rx.channels if c.nav.flagdec]
    bad = [f"{c.cfg.prn} locked {c.locked} decoded {c.nav.flagdec}"
           for c in rx.channels if not c.locked
           or not (c.nav.flagdec or scen == "weak")]
    if not decoded:
        bad.append("no satellite decoded")
    bad += [f"event {e}" for e in rx.events if e[0] == "lol"]
    blank = [k for k, v in obs.items() if not np.isfinite(v).all()]
    n_glo = sum(1 for _, sid in obs if sid[0] == "R")
    need_glo = {"glo": 5, "fullenv_glo": 40}.get(scen, 0)
    if len(obs) < spec["n_common"] or blank or n_glo < need_glo:
        bad.append(f"{len(obs)} observations (need {spec['n_common']}),"
                   f" {n_glo} GLONASS (need {need_glo}), blank fields "
                   f"{blank[:4]}")
    sats = set(sid for _, sid in obs)
    if not sats <= set(truth) or (scen != "weak" and sats != set(truth)):
        bad.append(f"satellites {sorted(sats)} against {sorted(truth)}")
    tod0 = (TOW0 + (4.0 if scen.endswith("glo") else 0.0)) % 86400.0
    per = {}
    for (tod, sid), v in sorted(obs.items()):
        per.setdefault(sid, []).append((tod - tod0, v[0], v[2]))
    fits, dres, spikes = {}, {}, 0
    tol = RESID_TOL * RESID_SCALE.get(scen, 1.0)
    for sid, rows in per.items():
        t, P, D = np.asarray(rows).T
        if sid[0] == "S":
            keep = np.abs(D - np.median(D)) < SBAS_SPIKE
            spikes += int((~keep).sum())
            t, D = t[keep], D[keep]
        d0, rate, _ = truth[sid]
        dres[sid] = D - (d0 + rate * t)
        if len(t) < 3:
            bad.append(f"{sid}: {len(t)} epochs")
            continue
        fit = np.polyfit(t, D, 1)
        resid = np.abs(D - np.polyval(fit, t)).max()
        fits[sid] = (fit[0], resid)
        if abs(fit[0] - rate) >= SLOPE_TOL or resid >= tol:
            bad.append(f"{sid}: Doppler slope {fit[0]:.3f} Hz/s "
                       f"(truth {rate}), residual {resid:.3f} Hz "
                       f"(bound {tol:.2f})")
    # the clock-free pseudorange check against the first GPS satellite
    # (G and R: the S pseudorange steps by its anchor, ROADMAP Queue 3)
    first = next(sid for sid in truth if sid[0] == "G")
    ref = {r[0]: r for r in per.get(first, [])}
    prate = {}
    for sid, rows in per.items():
        common = [r for r in rows if r[0] in ref]
        if sid == first or sid[0] == "S" or len(common) < 3:
            continue
        t = np.asarray([r[0] for r in common])
        dP = np.asarray([r[1] - ref[r[0]][1] for r in common])
        dD = np.asarray([truth[sid][2] * r[2]
                         - truth[first][2] * ref[r[0]][2]
                         for r in common])
        prate[sid] = float(np.polyfit(t - t[0], dP, 1)[0] - dD.mean())
        if abs(prate[sid]) >= PRATE_TOL:
            bad.append(f"{sid}: pseudorange rate against {first} off "
                       f"lambda x dD by {prate[sid]:.3f} m/s")
    extra = ""
    if scen == "sbas":
        want = _sbas_expected(seconds)
        got = set((p, i) for p, i, _ in frames)
        seen = [k for k, m in enumerate(want) if m in got]
        # messages end at whole seconds; the last three of the capture
        # fall in its final block and the framer's latency, and
        # neither package emits them
        last = int(seconds) - 4
        missing = [k for k in range(seen[0] if seen else 0, last + 1)
                   if want[k] not in got] if seen else ["all"]
        ds = np.concatenate([r for sid, r in dres.items()
                             if sid[0] == "S"] or [np.zeros(0)])
        s_rms = float(np.sqrt((ds ** 2).mean())) if len(ds) else np.nan
        s_mean = float(ds.mean()) if len(ds) else np.nan
        extra = (f"; NovAtel frames {len(frames)}, messages "
                 f"{seen[0] if seen else None}-{last} of the capture "
                 f"all present with their ids: {not missing}; S "
                 f"Doppler about the truth: mean {s_mean:+.3f} Hz, RMS "
                 f"{s_rms:.3f} Hz, {spikes} epoch(s) more than "
                 f"{SBAS_SPIKE:g} Hz off")
        if missing or not seen or seen[0] > 12 or \
                not abs(s_mean) < SBAS_D_TOL or spikes > SBAS_SPIKES:
            bad.append(f"SBAS messages missing {missing[:6]}, first "
                       f"{seen[:1]}, S Doppler mean {s_mean}, {spikes} "
                       f"spikes")
    d_rms = float(np.sqrt((np.concatenate(list(dres.values())) ** 2
                           ).mean()))
    log(f"[{tag}] {kind} ({scen} INI, {seconds:.0f} s at {f_sf / 1e6:.3f} "
        f"Msps, {len(rx.channels)} channels, {len(decoded)} decoded): CLI "
        f"wall "
        f"{run['wall']:.1f} s, run {run['run_s']:.2f} s, "
        f"{len(run['epochs'])} epochs, {len(obs)} observations "
        f"({n_glo} GLONASS), Doppler RMS about the truth {d_rms:.3f} "
        f"Hz, slopes " + ", ".join(
            f"{a}{b:02d} {f[0]:.3f}" for (a, b), f in sorted(
                fits.items())[:4]) + (" ..." if len(fits) > 4 else "")
        + f" Hz/s, largest residual about a fit "
        f"{max((f[1] for f in fits.values()), default=np.nan):.3f} Hz,"
        f" pseudorange rates against {first[0]}{first[1]:02d} within "
        f"{max(map(abs, prate.values()), default=0.0):.3f} m/s; K1 "
        f"launches {k1}" + extra)
    if bad:
        raise AssertionError(f"[{tag}] {kind}: {bad[:8]}")
    return k1


def phase_parity(dev, paths: dict) -> int:
    """Phase 16: the parity tool's half of every scenario
    (``parity_vs_reference.run_mine``: the tool's INI files, the port's
    CLI with ``--quiet --device cuda``) on phase 4's captures at the
    tool's full width, then tests/test_highdyn.py's 30 Hz/s ramp through
    the ``highdyn`` INI; each run held against the simulation truth:
    every satellite locked and decoded (``weak``: one decoded) with no
    ``lol``, the scenario's observation count with no blank field (and
    its GLONASS count), every satellite's Doppler on the truth's slope
    (within SLOPE_TOL) with a residual about its fit below RESID_TOL
    (RESID_SCALE), each G and R satellite's pseudorange rate against the
    first GPS satellite's equal to the Doppler difference in metres
    (PRATE_TOL); ``sbas``: every message
    after the lock in the NovAtel stream with its payload and id, the S
    Doppler's mean within SBAS_D_TOL of the truth.  Returns K1's
    launches."""
    log("[16] the reference receiver's half is not run: it needs the "
        "reference C tree (GNSSLIB_REFERENCE/src), which the repository "
        "does not hold; every run below is held against the simulation "
        "truth instead")
    total = 0
    for kind in [f"par_{s}" for s in PARITY] + ["ramp"]:
        total += parity_run(dev, kind, paths[kind])
    log(f"[16] band_taps launches of phase 16 (8 scenarios and the ramp): "
        f"{total}")
    return total


def phase_wide(dev, capture: str, kind: str = "par_fullenv",
               corr=WIDE_CORR) -> int:
    """Phase 17, the receiver at 33 taps (WIDE_CORR: CORRN/CORRD/CORRP
    16/2/6, the DLL's +-6-sample spacing of the 13-tap runs): (a) the
    steady super-step of 32 channels by CUDA events at 13 and 33 taps
    (``scaling_channels`` at C = 32, one K1 launch per super-step); (b)
    phase 16's ``fullenv`` capture (``capture``: 32 GPS channels, 16.368
    Msps, 20 s) through the CLI at 33 taps, held to phase 16's gates
    against the truth (:func:`parity_run`), each steady program one K1
    launch per super-step; (c) that run's first steady block replayed
    from its graph against the eager loop from the block's own state,
    bit for bit.  Returns the K1 launches of (b)."""
    from gnsslib_tpu_torch.tools import scaling_channels
    from gnsslib_tpu_torch.track import fast as fastmod
    from gnsslib_tpu_torch.track import state_from_numpy, state_to_numpy
    rows = {}
    for c in (CORR, corr):
        (row,) = scaling_channels.run((32,), corr=c, device=dev)
        rows[c] = row
        log(f"[17a] {2 * c[0] + 1} taps: {scaling_channels.line(row)}")
        if row["k1_launches"] != row["expected"]:
            raise AssertionError(f"[17a] {c}: K1 launches "
                                 f"{row['k1_launches']} != {row['expected']}")
    ms = {c: r["ms_step_event"] for c, r in rows.items()}
    log(f"[17a] {card_line()}; the steady super-step of 32 channels x 10 "
        f"periods by CUDA events: {ms[corr]:.4f} ms at {2 * corr[0] + 1} "
        f"taps against {ms[CORR]:.4f} ms at 13 taps (x"
        f"{ms[corr] / ms[CORR]:.3f})")

    first = {}
    start = fastmod.FastTracker.run_block_start

    def keep_first(self, state, block, nsteps):
        if not first:
            first.update(eng=self, state=state_to_numpy(state),
                         block=block.clone(), nsteps=nsteps)
        return start(self, state, block, nsteps)
    fastmod.FastTracker.run_block_start = keep_first
    try:
        k1 = parity_run(dev, kind, capture, corr=corr, tag="17b")
    finally:
        fastmod.FastTracker.run_block_start = start
    eng = first["eng"]
    _replay_vs_eager(f"the wide receiver's first steady block ("
                     f"{len(eng.offsets)} taps, {eng.C} channels)", eng,
                     state_from_numpy(first["state"], dev), first["block"],
                     first["nsteps"], phase="17c")
    return k1


def with_graphs(tag: str, phase, *args):
    """Run ``phase(*args)`` and log the block-program captures it made and
    its wall time."""
    from gnsslib_tpu_torch.track.program import CAPTURES
    n, rec, inst, pool = (CAPTURES.captures, CAPTURES.capture_s,
                          CAPTURES.instantiate_s, CAPTURES.pool_bytes)
    t0 = time.time()
    out = phase(*args)
    log(f"[{tag}] graphs: {CAPTURES.captures - n} block-program captures, "
        f"{CAPTURES.capture_s - rec:.2f} s recording, "
        f"{CAPTURES.instantiate_s - inst:.2f} s instantiating, pools "
        f"{(CAPTURES.pool_bytes - pool) / 1e6:.1f} MB; phase wall "
        f"{time.time() - t0:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card — refusing to run",
              file=sys.stderr)
        return 2
    import gnsslib_tpu_torch  # noqa: F401  (fails outside a checkout)
    from gnsslib_tpu_torch import cuda_build, native
    from gnsslib_tpu_torch.ops import band_taps as bt
    from gnsslib_tpu_torch.track.program import CAPTURES

    t_all = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"[1] card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.time()
    if not native.available():
        raise RuntimeError("the native host kernels did not build (g++ on "
                           f"{native.SOURCE})")
    log(f"[2] native host kernels (SBAS Viterbi, CRC-24Q, unpackers) built "
        f"by g++ in {time.time() - t0:.1f} s: {native.library_path()}")
    t0 = time.time()
    cuda_build.build_all(KERNELS)
    bt.load_kernel()
    log(f"[2] built csrc/{{{','.join(KERNELS)}}}.cu in parallel in "
        f"{time.time() - t0:.1f} s (nvcc "
        + ", ".join(f"{k} {cuda_build.build_info.get(k, (0.0, ''))[0]:.1f} s"
                    for k in KERNELS) + ")")
    for name in KERNELS:                 # ptxas -v, 13-tap instantiations
        entry = ""
        for ln in cuda_build.build_info.get(name, (0.0, ""))[1].splitlines():
            if "Compiling entry function" in ln:
                entry = ln
                continue
            if not re.search(r"registers|spill", ln):
                continue
            wide = re.search(r"band_taps_(wide|v1_wide)_kernelILb(\d)E"
                             r"(?:Lb(\d)E)?", entry)
            var = re.search(r"ablation_taps_v1_kernelILi(\d)ELi13EE", entry)
            k6 = re.search(r"ablation_taps_cluster_kernelILb(\d)ELi(\d+)EE",
                           entry)
            k1 = re.search(r"(?:band|window|gram)_taps_(v1|cluster|mma)_"
                           r"kernelILi(\d+)ELb(\d)E", entry)
            # 13-tap instantiations (K2's banded Gram: its 7 n-tiles), the
            # 25-tap ones of K1 and K2 (K2: 11 n-tiles), and K1's wide
            # kernels (any T > 25)
            at25 = {"band_taps": ("cluster", "25"),
                    "gram_taps": ("mma", "11")}
            if wide:
                kind = (f"{wide[1].replace('_', ' ')} (T > 25) "
                        + ("iq" if wide[2] == "1" else "real")
                        + {"1": " staged", "0": " recompute"}.get(
                            wide[3], ""))
            elif k1 and ((k1[1], k1[2]) in (("mma", "7"), at25.get(name))
                         or (k1[1] != "mma" and k1[2] == "13")):
                size = f"NN={k1[2]}" if k1[1] == "mma" else f"T={k1[2]}"
                kind = f"{k1[1]} {size} " + ("iq" if k1[3] == "1"
                                             else "real") + (
                    " bf16" if "bfloat16" in entry else "")
            elif var:
                kind = "v1 " + ("full", "nosin", "onetap",
                                "aligned")[int(var[1])]
            elif k6 and (k6[2] == "13" or (k6[1], k6[2]) == ("0", "1")):
                # full and aligned share an instantiation; onetap is its
                # one-tap chain
                kind = "cluster " + ("nosin" if k6[1] == "1" else
                                     "full/aligned" if k6[2] == "13" else
                                     "onetap") + f" T={k6[2]}"
            else:
                continue
            log(f"[2]   {name} {kind}: {ln.split(':', 1)[-1].strip()}")
    # K1's 13-tap I/Q instantiation (the G1 group's) must not spill
    from gnsslib_tpu_torch.tools import profile_band as pb
    from gnsslib_tpu_torch.tools import receiver_throughput as rxt
    text = cuda_build.build_info.get("band_taps", (0.0, ""))[1]
    if not text:                      # built by an earlier run: build again
        pb.build(["kernel"])
        text = pb._LIBS["kernel"][1]
    usage = pb.usage(text, True)
    log(f"[2] band_taps cluster T=13 iq: {pb.usage_text(usage)} (capped at "
        f"64 registers it spilled: an 80-byte stack frame, 132 bytes of "
        f"spill stores)")
    if usage.get("stack") != 0 or usage.get("spill_stores") != 0:
        raise AssertionError(f"band_taps cluster T=13 iq spills: {usage}")

    t3 = time.time()
    k = {"band_taps": [phase_kernel(dev, iq=False),
                       phase_kernel(dev, iq=True)]}
    # K1 at phase 16's 9-tap shapes: the two-satellite scenarios' real
    # super-step (4.092 Msps, CORR 4/2/2) and the ppm scenario's I/Q one
    # (2.048 Msps, CORR 4/1/1)
    k9 = {"real": phase_kernel(dev, False, "3 9-tap", corr=(4, 2, 2),
                               sf=4.092e6, fif=1.023e6, channels=2),
          "iq": phase_kernel(dev, True, "3 9-tap", corr=(4, 1, 1),
                             sf=2.048e6, fif=0.0, channels=2)}
    k["band_taps"] += list(k9.values())
    # K1 past 25 taps: its wide kernel, one launch per super-step
    wide = {}
    for corr in pb.WIDE:
        for iq in (False, True):
            wide[2 * corr[0] + 1, iq] = phase_kernel(
                dev, iq, f"3 {2 * corr[0] + 1}-tap", corr=corr)
    k["band_taps"] += list(wide.values())
    for iq in (False, True):
        for name, r in phase_window_kernels(dev, iq).items():
            k.setdefault(name, []).append(r)
        k.setdefault("gram_taps", []).append(phase_gram_kernel(dev, iq))
    # K2-K5 at 33 taps (real): a launch per group of at most 25 taps
    wide33 = phase_window_kernels(dev, False, WIDE_CORR, "3 33-tap")
    wide33["gram_taps"] = phase_gram_kernel(dev, False, WIDE_CORR,
                                            "3 33-tap")
    for name, r in wide33.items():
        k[name].append(r)
    phase_window_profiler(dev)
    phase_gram_profiler(dev)
    ablation = phase_ablation_kernel(dev)
    # the K6 row: the full variant (K4's body); max_abs_err over all four
    k["ablation_taps"] = [dict(ablation["full"], err=max(
        r["err"] for r in ablation.values()))]
    log(f"[3] phase wall {time.time() - t3:.1f} s (the 33-, 41- and 65-tap "
        f"checks included)")

    os.makedirs(WORK, exist_ok=True)
    paths = {k: os.path.join(WORK, f"capture_{k}_int8.bin")
             for k in ("slice", "pos", "fe1", "fe2", "rtl", "edge", "mh",
                       "ramp") + tuple(f"par_{s}" for s in PARITY)}
    paths["rx"] = rxt.cache_path(RX_SECONDS)
    capture, capture_pos = paths["slice"], paths["pos"]
    starts = edge_starts()
    phase_synth(dev, paths, starts)
    CAPTURES.reset()
    with_graphs("5", phase_fast_vs_cpu, dev, capture, paths["fe1"],
                paths["fe2"])
    slice_k1, ref_events, ref_epochs, ref = with_graphs("6", phase_slice,
                                                        dev, capture)
    launches = {"band_taps": slice_k1}
    with_graphs("7", phase_throughput, dev)
    prof = with_graphs("8", phase_profiler, dev)
    launches.update({n: prof[n] for n in prof if n != "band_taps"})
    launches["ablation_taps"] = phase_kernel_profiler(dev)["launches"]
    with_graphs("10", phase_positioning, dev, capture_pos)
    # the multi-GNSS path: its K1 launches (three groups, one of them I/Q)
    # join the slice's in the band_taps row
    multi, multi_iq = with_graphs("11", phase_multi, dev, paths["fe1"],
                                  paths["fe2"])
    log(f"[11] band_taps launches on the main paths: slice (phase 6) "
        f"{launches['band_taps']}, multi-GNSS (phase 11) {multi}, of which "
        f"I/Q {multi_iq}")
    launches["band_taps"] += multi
    # the live entry point: the pacer (real K1) and the RTL-SDR CLI (I/Q
    # K1) join the band_taps row; the edge check is not a main path
    live = with_graphs("12a", phase_live, dev, capture, ref_events,
                       ref_epochs)
    live_iq, err_iq = with_graphs("12b", phase_live_rtlsdr, dev,
                                  paths["rtl"])
    k["band_taps"].append({"err": err_iq})
    edge = with_graphs("12c", phase_edge, dev, paths["edge"], starts)
    log(f"[12] band_taps launches on the live paths: pacer (12a) {live}, "
        f"RTL-SDR I/Q (12b) {live_iq}; the edge check (12c) {edge}")
    launches["band_taps"] += live + live_iq
    # the diagnostics and the pipeline options: every K1 launch of their
    # runs joins the band_taps row
    diag = with_graphs("13", phase_diag, dev, capture, paths["fe1"],
                       paths["fe2"], ref_events, ref_epochs, ref)
    log(f"[13] band_taps launches of phase 13 (SPEC and --watch-html, the "
        f"pipeline modes, the MultiReceiver with SPEC, --profile and its "
        f"unprofiled twin): {diag}")
    launches["band_taps"] += diag
    # the receiver tools: the K1 launches of their receiver runs join the
    # band_taps row, and K1's error at 256 channels its max_abs_err
    tools_k1, err_256 = with_graphs("14", phase_tools, dev)
    launches["band_taps"] += tools_k1
    k["band_taps"].append({"err": err_256})
    # the multi-device layer: the K1 launches of its receiver runs (the
    # mesh receiver, the CLI, both demo processes) join the band_taps row,
    # and K1's error at the shard shapes its max_abs_err
    par_k1, err_15 = with_graphs("15", phase_parallel, dev, capture,
                                 paths["mh"], ref_events, ref_epochs)
    launches["band_taps"] += par_k1
    k["band_taps"].append({"err": err_15})
    # the parity tool's half of every scenario and the 30 Hz/s ramp: their
    # K1 launches join the band_taps row
    parity_k1 = with_graphs("16", phase_parity, dev, paths)
    launches["band_taps"] += parity_k1
    # the receiver at 33 taps: its K1 launches join the band_taps row
    wide_k1 = with_graphs("17", phase_wide, dev, paths["par_fullenv"])
    launches["band_taps"] += wide_k1
    log(f"[17] K1 past 25 taps (phase 3, graph replay, real/I/Q): "
        + "; ".join(f"{T} taps {wide[T, False]['ms']:.4f}/"
                    f"{wide[T, True]['ms']:.4f} ms (bound "
                    f"{wide[T, False]['bound_ms']:.4f}/"
                    f"{wide[T, True]['bound_ms']:.4f})"
                    for T in sorted({t for t, _ in wide}))
        + f"; phase 17's launches {wide_k1}")
    log(f"[16] K1 at the scenarios' 9-tap shapes (phase 3): real "
        f"{k9['real']['ms']:.4f} ms, I/Q {k9['iq']['ms']:.4f} ms per launch "
        f"(bounds {k9['real']['bound_ms']:.4f} / {k9['iq']['bound_ms']:.4f} "
        f"ms); phase 16's launches {parity_k1}")
    log(f"[graphs] phases 5-17: {CAPTURES.captures} block-program captures "
        f"(the CLI runs' included), {CAPTURES.capture_s:.2f} s recording, "
        f"{CAPTURES.instantiate_s:.2f} s instantiating, pools "
        f"{CAPTURES.pool_bytes / 1e6:.1f} MB reserved in all; device memory "
        f"peak {torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved")
    log(f"total {time.time() - t_all:.1f} s")

    log(card_line())
    where = {
        "band_taps": ("band_taps.cu", "gnsslib_tpu/ops/pallas_gram.py:192"),
        "gram_taps": ("gram_taps.cu", "gnsslib_tpu/ops/pallas_gram.py:267"),
        "correlate_windows16": ("window_taps.cu",
                                "gnsslib_tpu/ops/pallas_corr.py:236"),
        "correlate_windows8": ("window_taps.cu",
                               "gnsslib_tpu/ops/pallas_corr.py:156"),
        "correlate_windows": ("window_taps.cu",
                              "gnsslib_tpu/ops/pallas_corr.py:66"),
        "ablation_taps": ("ablation_taps.cu", "tools/profile_kernel.py:40"),
    }
    rows = []
    for name, (src, replaces) in where.items():
        real = k[name][0]          # real input: the main path's signal
        rows.append({
            "name": name, "route": "cuda",
            "source": f"gnsslib_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in k[name]),
            "ms": real["ms"], "plain_ms": real["plain_ms"],
            "bound_ms": real["bound_ms"], "bound_by": real["bound_by"],
            # no single PyTorch call mixes, masks and sums the shifted taps
            "library_ms": None,
            # how "ms" was timed (launches replayed from a CUDA graph), the
            # same launches eager, and the same run's v1 kernel
            "timing": real["timing"], "eager_ms": real["eager_ms"],
            "v1_ms": real["v1_ms"],
            # past 25 taps (real input, graph replay): K1's wide kernel at
            # 33/41/65 taps, K2-K5's launches of at most 25 taps at 33
            "wide_ms": ({str(T): r["ms"] for (T, iq), r in wide.items()
                         if not iq} if name == "band_taps"
                        else {"33": wide33[name]["ms"]}
                        if name in wide33 else None)})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
