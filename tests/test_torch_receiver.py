"""The port's file-replay Receiver against the JAX Receiver on one
synthesized capture (2 visible + 2 absent GPS L1CA PRNs, 16 s at
4.092 Msps), both driven from the same INI files through their
``load_ini`` + ``Receiver.run_seconds``; checkpoint and resume; the
port's CLI; and the cooperative stop (``Receiver.request_stop``, and
SIGINT/SIGTERM on the CLI)."""
import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from gnsslib_tpu import sim
from gnsslib_tpu.constants import DType
from gnsslib_tpu.io.frontend import FileFrontend
from gnsslib_tpu.runtime.config import load_ini as jax_load_ini
from gnsslib_tpu.runtime.receiver import Receiver as JaxReceiver
from gnsslib_tpu_torch.runtime.cli import UNPORTED_FLAGS
from gnsslib_tpu_torch.runtime.cli import main as torch_cli
from gnsslib_tpu_torch.runtime.config import load_ini, unported_options
from gnsslib_tpu_torch.runtime.receiver import Receiver
from torch_reference_loop import reference_carrier_loop  # noqa: F401

# the carrier loop's pull-in as the reference and the JAX package run it
# (tests/torch_reference_loop.py): the port's FLL pulls in alone first
pytestmark = pytest.mark.usefixtures("reference_carrier_loop")
torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
DELAYS = {3: 300, 21: 1300}          # visible PRN -> delay (samples)
PRNS = (3, 5, 21, 30)                # 5 and 30 are absent
SECONDS = 16.0


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_rx")
    chans = []
    for prn, d in DELAYS.items():
        eph = sim.example_eph(prn=prn, week=2200, toe_tow=TOW0)
        frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=5)
        # 300 pad bits (6 s) ending +1,+1 so word-1 parity sees D29*=D30*=0
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=prn, doppler=500.0 + 100.0 * prn,
            code_phase=-d * 1.023e6 / F_SF, carr_phase=0.1 * prn,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    path = tmp / "sim_l1ca.bin"
    with open(path, "wb") as f:
        step = int(F_SF)
        for t0 in range(0, n, step):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=1000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    fend = tmp / "fend.ini"
    fend.write_text(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    ={path}
[TRACK]
CORRN    =4
CORRD    =2
CORRP    =2
""")
    ini = tmp / "rx.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={fend}
[CHANNEL]
NCH      ={len(PRNS)}
PRN      ={",".join(str(p) for p in PRNS)}
SYS      ={",".join("1" for _ in PRNS)}
CTYPE    ={",".join("1" for _ in PRNS)}
FTYPE    ={",".join("1" for _ in PRNS)}
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={tmp}/out
""")
    return tmp, ini


def _record(rx) -> list:
    """The list that ``rx``'s hub appends its emitted epochs to."""
    epochs = []
    orig = rx.hub.emit_epochs

    def record(inputs):
        out = orig(inputs)
        epochs.extend(out)
        return out
    rx.hub.emit_epochs = record
    return epochs


def _run(rx):
    epochs = _record(rx)
    rx.run_seconds()
    rx.close()
    return epochs


@pytest.fixture(scope="module")
def both(capture):
    _, ini = capture
    jcfg, tcfg = jax_load_ini(str(ini)), load_ini(str(ini))
    jcfg.rinex = False                   # the port writes RINEX, JAX not
    jrx = JaxReceiver(jcfg, FileFrontend(jcfg.files[0], jcfg.fends[0]))
    trx = Receiver(tcfg, FileFrontend(tcfg.files[0], tcfg.fends[0]),
                   device="cpu")
    return (jrx, _run(jrx)), (trx, _run(trx))


def test_receiver_matches_jax(both):
    """Same acquisition decisions, nav event sequence, epoch TOWs and
    satellites, decoded ephemeris; pseudorange within 1 m and Doppler
    within 0.5 Hz.  The two packages' tracking loops differ only in f32
    summation order (and the steady-state correlator's bf16 rounding on
    the JAX side), far below the DLL/PLL noise these bounds allow."""
    (jrx, jep), (trx, tep) = both
    acq_j = [e for e in jrx.events if e[0] == "acq"]
    acq_t = [e for e in trx.events if e[0] == "acq"]
    assert [e[:3] for e in acq_t] == [e[:3] for e in acq_j]
    assert sorted(e[2] for e in acq_t) == sorted(DELAYS)
    for a, b in zip(acq_j, acq_t):
        assert b[3] == pytest.approx(a[3], abs=1e-3)       # cn0 (dB-Hz)
        assert b[4] == pytest.approx(a[4], rel=1e-4)       # peak ratio
    nav_j = [e for e in jrx.events if e[0].startswith("nav:")]
    nav_t = [e for e in trx.events if e[0].startswith("nav:")]
    assert nav_t == nav_j
    assert any(e[0] == "nav:decode" for e in nav_t)
    assert [c.locked for c in trx.channels] == \
        [c.locked for c in jrx.channels] == [p in DELAYS for p in PRNS]
    assert "steady" in trx.timeline and "steady" in jrx.timeline

    def by_tow(eps):
        return {round(o[0].tow, 3): {x.prn: x for x in o} for o in eps}
    tj, tt = by_tow(jep), by_tow(tep)
    assert len(tt) >= 3
    assert sorted(tt) == sorted(tj)
    for tow in tj:
        assert sorted(tt[tow]) == sorted(tj[tow]) == sorted(DELAYS)
        for prn in tj[tow]:
            assert tt[tow][prn].P == pytest.approx(tj[tow][prn].P, abs=1.0)
            assert tt[tow][prn].D == pytest.approx(tj[tow][prn].D, abs=0.5)
    for cj, ct in zip(jrx.channels, trx.channels):
        assert ct.nav.flagdec == cj.nav.flagdec
        assert ct.nav.firstsftow == cj.nav.firstsftow
        ej, et = cj.nav.eph.eph, ct.nav.eph.eph
        for f in ("week", "iodc", "iode", "sva", "svh", "f0", "f1", "f2",
                  "tgd", "A", "e", "i0", "OMG0", "omg", "M0", "deln"):
            assert getattr(et, f) == getattr(ej, f), f


def test_receiver_pseudorange_truth(both):
    """Port's pseudorange difference against the synthesized delays
    (test_receiver.py's check): DLL jitter at 47 dB-Hz is a few metres."""
    from gnsslib_tpu.constants import CLIGHT
    _, (trx, tep) = both
    last = tep[-1]
    P = {o.prn: o.P for o in last}
    t = last[0].tow - TOW0
    ddopp = 100.0 * (21 - 3)
    dP_expect = (CLIGHT / F_SF * (DELAYS[21] - DELAYS[3])
                 + CLIGHT * ddopp / 1.57542e9 * t)
    # PTIMING offset: measured at reftow, stamped reftow + PTIMING
    from gnsslib_tpu.constants import PTIMING
    dP_expect -= CLIGHT * ddopp / 1.57542e9 * PTIMING / 1000.0
    assert P[21] - P[3] == pytest.approx(dP_expect, abs=15.0)


def test_receiver_writes_rinex_obs(both):
    """The port's RINEX obs file carries one record per emitted epoch,
    each with both visible satellites."""
    _, (trx, tep) = both
    lines = open(trx.obs_writer.path).read().splitlines()
    epochs = [ln for ln in lines if ln.startswith(">")]
    assert len(epochs) == len(tep) == trx.epochs_written
    assert all(int(ln.split()[-1]) == 2 for ln in epochs)
    assert {ln[:3] for ln in lines if ln[:1] == "G" and ln[1:3].isdigit()
            } == {"G03", "G21"}


def test_cli_runs_on_cpu(capture, tmp_path):
    """``python -m gnsslib_tpu_torch cfg.ini --device cpu`` end to end
    (the first 3 s: acquisition and pull-in) writes its RINEX files."""
    _, ini = capture
    cli_ini = tmp_path / "cli.ini"
    cli_ini.write_text(re.sub(r"RINEXPATH=.*", f"RINEXPATH={tmp_path}/cli",
                              ini.read_text()))
    assert torch_cli([str(cli_ini), "--device", "cpu", "--quiet",
                      "--seconds", "3"]) == 0
    out = tmp_path / "cli"
    assert sorted(p[-3:] for p in os.listdir(out)) == ["nav", "obs"]


def test_checkpoint_resume_matches_uninterrupted(both, capture, tmp_path):
    """Stopped at 8 s with a checkpoint, resumed in a new receiver: the
    epochs after the checkpoint are the uninterrupted run's (same TOWs and
    satellites, pseudoranges within 1 m)."""
    _, ini = capture
    _, (_, full) = both

    def mk():
        cfg = load_ini(str(ini))
        cfg.rinex = False
        return Receiver(cfg, FileFrontend(cfg.files[0], cfg.fends[0]),
                        device="cpu")
    rx_a = mk()
    before = _record(rx_a)
    rx_a.run_seconds(8.0)
    ck = str(tmp_path / "rx.ckpt")
    rx_a.save_checkpoint(ck)
    rx_a.close()
    rx_b = mk()
    rx_b.load_checkpoint(ck)
    assert rx_b.base == rx_a.base and rx_b.epochs_written == \
        rx_a.epochs_written == len(before)
    resumed = _run(rx_b)
    assert len(resumed) >= 3 and len(before) + len(resumed) == len(full)
    for a, b in zip(full[len(before):], resumed):
        assert b[0].tow == a[0].tow
        assert [o.prn for o in b] == [o.prn for o in a]
        for oa, ob in zip(a, b):
            assert ob.P == pytest.approx(oa.P, abs=1.0)
    assert rx_b.epochs_written == len(full)


@pytest.mark.parametrize("key,value,name", [
    ("relock", True, "RELOCK"), ("hotstart", True, "HOTSTART"),
    ("acqconfirm", True, "ACQCONFIRM"), ("spp", True, "SPP"),
    ("rtcm", True, "RTCM"), ("sbas", True, "SBAS"), ("log", True, "LOG"),
    ("spec", True, "SPEC"), ("smooth", 5, "SMOOTH")])
def test_unported_options_raise(capture, tmp_path, key, value, name):
    """No configured option is refused any more: each option, ported since
    the first slice, builds a receiver that carries it (SBAS: the hub's
    NovAtel stream server; SPEC: the spectrum monitor on the front end)."""
    _, ini = capture
    cfg = load_ini(str(ini))
    cfg.rinex, cfg.logpath, cfg.rtcmport = False, str(tmp_path), 0
    cfg.sbasport = 0
    setattr(cfg, key, value)
    fe = FileFrontend(cfg.files[0], cfg.fends[0])
    assert unported_options(cfg) == []
    rx = Receiver(cfg, fe, device="cpu")
    try:
        carried = {"RELOCK": rx.cfg.relock, "HOTSTART": rx.cfg.hotstart,
                   "ACQCONFIRM": rx.acq.confirm, "SPP": rx.hub.spp,
                   "RTCM": rx.hub.rtcm_srv is not None,
                   "SBAS": rx.hub.sbas_srv is not None,
                   "LOG": len(rx.loggers) == len(PRNS),
                   "SPEC": rx.spec_monitor is not None
                   and rx.spec_monitor.fe is fe,
                   "SMOOTH": rx.hub.smoother is not None
                   and rx.hub.smoother.N == 5}
        assert carried[name]
    finally:
        rx.close()
    if name == "LOG":
        assert sorted(os.listdir(tmp_path)) == sorted(
            f"logG{p:02d}.csv" for p in PRNS)


@pytest.mark.parametrize("flag", ["--devices", "--checkpoint", "--watch",
                                  "--resume", "--spp", "--ftype"])
def test_unported_cli_flags_raise(capture, tmp_path, flag, capsys):
    """Flags the port does not carry raise (none is left); the others run:
    ``--devices 2`` on the CPU writes the same RINEX bytes and prints the
    same events as the run without it, a checkpoint written after 2 s
    resumes to 3 s, ``--spp`` opens the .pos file beside RINEX, ``--ftype
    1`` runs the one configured path (``--ftype 2``, a path the config
    does not define, is refused), and ``--watch`` draws its dashboard for
    2 s."""
    _, ini = capture
    if flag in UNPORTED_FLAGS:
        with pytest.raises(NotImplementedError, match=flag):
            torch_cli([str(ini), "--device", "cpu", flag, "2"])
        return
    cli_ini = tmp_path / "cli.ini"
    cli_ini.write_text(re.sub(r"RINEXPATH=.*", f"RINEXPATH={tmp_path}/out",
                              ini.read_text()))
    base = [str(cli_ini), "--device", "cpu", "--quiet"]
    ck = str(tmp_path / "rx.ckpt")
    if flag == "--devices":
        runs = []
        for name, extra in (("one", []), ("two", ["--devices", "2"])):
            ini_n = tmp_path / f"{name}.ini"
            ini_n.write_text(re.sub(r"RINEXPATH=.*",
                                    f"RINEXPATH={tmp_path}/{name}",
                                    ini.read_text()))
            capsys.readouterr()
            assert torch_cli([str(ini_n), "--device", "cpu", "--seconds",
                              "2"] + extra) == 0
            events = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("  event:")]
            # the files' bytes, but for the header line with the run's date
            files = {p[-3:]: [ln for ln in open(tmp_path / name / p)
                              if "PGM / RUN BY / DATE" not in ln]
                     for p in os.listdir(tmp_path / name)}
            runs.append((events, files))
        assert runs[0][0] and runs[0] == runs[1]
        assert sorted(runs[0][1]) == ["nav", "obs"]
        return
    if flag == "--spp":
        assert torch_cli(base + ["--seconds", "2", "--spp"]) == 0
        assert sorted(p[-3:] for p in os.listdir(tmp_path / "out")) == \
            ["nav", "obs", "pos"]
        return
    if flag == "--watch":
        assert torch_cli(base + ["--seconds", "2", "--watch"]) == 0
        out = capsys.readouterr().out
        assert "locked" in out and "\x1b[J" in out
        return
    if flag == "--ftype":
        assert torch_cli(base + ["--seconds", "2", "--ftype", "2"]) == 1
        assert torch_cli(base + ["--seconds", "2", "--ftype", "1"]) == 0
        assert sorted(p[-3:] for p in os.listdir(tmp_path / "out")) == \
            ["nav", "obs"]
        return
    assert torch_cli(base + ["--seconds", "2", "--checkpoint", ck]) == 0
    assert os.path.getsize(ck) > 0
    if flag == "--resume":
        assert torch_cli(base + ["--seconds", "3", "--resume", ck]) == 0


def test_cli_devices_beyond_cards(capture, capsys):
    """``--devices N`` with ``--device cuda`` and fewer than N cards ends
    the run with the JAX package's message and exit code 1, and never
    falls back to the CPU."""
    _, ini = capture
    have = torch.cuda.device_count()
    n = max(2, have + 1)
    assert torch_cli([str(ini), "--device", "cuda", "--devices", str(n),
                      "--seconds", "2", "--quiet"]) == 1
    err = capsys.readouterr().err
    assert f"need {n} devices, have {have}" in err


def _mk(ini):
    """A port receiver on the CPU from ``ini``, without RINEX output."""
    cfg = load_ini(str(ini))
    cfg.rinex = False
    return Receiver(cfg, FileFrontend(cfg.files[0], cfg.fends[0]),
                    device="cpu")


@pytest.fixture(scope="module")
def stopped(capture, tmp_path_factory):
    """A run stopped through ``request_stop`` once 12 s of stream are done
    (from its progress callback, as the CLI's signal handler does), and
    its checkpoint: (epochs before the stop, checkpoint path).  The first
    epoch comes ~1.6 s of stream later, so a run resumed from it writes
    one within a few blocks."""
    _, ini = capture
    rx = _mk(ini)
    epochs = _record(rx)
    keys = (list(rx.trk.programs), list(rx.fast.programs))

    def progress(t):
        if t >= 12.0:
            rx.request_stop()
    stats = rx.run_seconds(progress=progress)
    assert rx.stop_requested and 12.0 <= stats["seconds"] < 13.0
    # one program per engine, built at construction and reused
    assert (list(rx.trk.programs), list(rx.fast.programs)) == keys
    assert [len(k) for k in keys] == [1, 1]
    ck = str(tmp_path_factory.mktemp("stop") / "stop.ckpt")
    rx.save_checkpoint(ck)
    rx.close()
    return epochs, ck


def test_request_stop_checkpoint_resumes(both, capture, stopped):
    """``request_stop`` ends ``run_seconds`` at a block boundary with the
    blocks in flight collected; its checkpoint resumes to the
    uninterrupted run's epochs."""
    _, ini = capture
    _, (_, full) = both
    before, ck = stopped
    rx = _mk(ini)
    rx.load_checkpoint(ck)
    assert rx.epochs_written == len(before)
    resumed = _run(rx)
    assert len(resumed) >= 3 and len(before) + len(resumed) == len(full)
    for a, b in zip(full[len(before):], resumed):
        assert b[0].tow == a[0].tow
        assert [o.prn for o in b] == [o.prn for o in a]
        for oa, ob in zip(a, b):
            assert ob.P == pytest.approx(oa.P, abs=1.0)


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM],
                         ids=["SIGINT", "SIGTERM"])
def test_cli_signal_stops_cleanly(both, capture, stopped, tmp_path, sig):
    """``python -m gnsslib_tpu_torch`` resumed from the stopped run's
    checkpoint and signalled once its first epoch is written: exit 0,
    every RINEX epoch complete and in the new checkpoint (the blocks in
    flight were flushed before it was written), which resumes to the
    uninterrupted run's epochs (tests/test_interrupt.py's counterpart)."""
    _, ini = capture
    _, (_, full) = both
    before, ck = stopped
    cli_ini = tmp_path / "cli.ini"
    outdir = tmp_path / "out"
    cli_ini.write_text(re.sub(r"RINEXPATH=.*", f"RINEXPATH={outdir}",
                              ini.read_text()))
    ck2 = tmp_path / "sig.ckpt"
    # two threads, as this process has: the default (one per core) is
    # oversubscribed when the other test workers run beside it
    env = dict(os.environ, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(__file__)),
                    env.get("PYTHONPATH", "")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "gnsslib_tpu_torch", str(cli_ini), "--device",
         "cpu", "--resume", ck, "--checkpoint", str(ck2)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path))
    try:
        # the banner comes after the handlers are installed
        assert proc.stdout.readline().startswith(b"gnsslib_tpu_torch:")
        deadline = time.time() + 120
        while not _obs_epochs(outdir):
            assert proc.poll() is None, "the run ended before the signal"
            assert time.time() < deadline, "no epoch before the deadline"
            time.sleep(0.2)
        proc.send_signal(sig)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out.decode(errors="replace")[-2000:]
    assert b"stopping" in out
    text = open(_obs_epochs(outdir)).read().splitlines()
    assert any("END OF HEADER" in ln for ln in text)
    heads = [i for i, ln in enumerate(text) if ln.startswith(">")]
    for i in heads:                          # every epoch has its records
        nsat = int(text[i].split()[-1])
        assert all(ln[:1] == "G" for ln in text[i + 1:i + 1 + nsat])
        assert len(text) >= i + 1 + nsat
    with open(ck2, "rb") as f:
        snap = pickle.load(f)
    assert snap["epochs"] == len(before) + len(heads)
    rx = _mk(ini)
    assert snap["base"] + rx.block_len <= rx.end_sample()  # stopped early
    rx.load_checkpoint(str(ck2))
    resumed = _run(rx)
    assert len(before) + len(heads) + len(resumed) == len(full)
    for a, b in zip(full[len(before) + len(heads):], resumed):
        assert b[0].tow == a[0].tow
        assert [o.prn for o in b] == [o.prn for o in a]


def _obs_epochs(outdir):
    """The RINEX obs file under ``outdir`` once it holds an epoch, else
    None."""
    if not os.path.isdir(outdir):
        return None
    for p in os.listdir(outdir):
        path = os.path.join(outdir, p)
        if p.endswith(".obs") and any(ln.startswith(">")
                                      for ln in open(path)):
            return path
    return None
