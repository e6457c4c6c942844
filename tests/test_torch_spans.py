"""The receiver's span table (``gnsslib_tpu_torch/spans.py``,
``Receiver.spans``) on the CPU: the table's own bookkeeping on made-up
spans, and one small capture (one GPS L1CA PRN at 47 dB-Hz, 13 s at
4.092 Msps: acquisition, pull-in, steady state and epochs) through a
pipelined and a sequential receiver, the pipelined one partly under
``torch.profiler``."""
import json

import numpy as np
import pytest
import torch

from gnsslib_tpu_torch import sim, spans
from gnsslib_tpu_torch.constants import DType
from gnsslib_tpu_torch.io.frontend import FileFrontend
from gnsslib_tpu_torch.runtime.config import load_ini
from gnsslib_tpu_torch.runtime.receiver import Receiver
from gnsslib_tpu_torch.tools import profile_receiver

torch.set_num_threads(2)

F_SF = 4.092e6
F_IF = 1.023e6
TOW0 = 352800.0
PRN, DELAY = 3, 300
SECONDS = 13.0
PROFILED = 2                 # steady blocks run under the profiler

# every span the receiver opens on a plain GPS capture; per tracking block
# of its stage (acquire: per block) and, pipelined, per collected block
PER_BLOCK = ("step_block", "acq.collect", "acq.dispatch")
PER_TRACK = ("cache.get", "track.dispatch", "place")
NAMES = set(PER_BLOCK + PER_TRACK) | {
    "acq.wait", "acq.ready", "track.collect", "track.wait", "track.ready",
    "track.unpack", "nav", "obs.hist", "obs.epoch"}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spans")
    eph = sim.example_eph(prn=PRN, week=2200, toe_tow=TOW0)
    frames = sim.lnav_bit_stream(eph, TOW0 + 6.0, nframes=2)
    # 300 pad bits (6 s) ending +1,+1 so word-1 parity sees D29*=D30*=0
    pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
    ch = sim.SimChannel(prn=PRN, doppler=800.0,
                        code_phase=-DELAY * 1.023e6 / F_SF, carr_phase=0.3,
                        nav_bits=np.concatenate([pad, frames]))
    noise = sim.noise_std_for_cn0(1.0, 47.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    path = tmp / "sim_l1ca.bin"
    with open(path, "wb") as f:
        step = int(F_SF)
        for t0 in range(0, n, step):
            x = sim.synthesize([ch], F_SF, F_IF, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=2000 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    (tmp / "fend.ini").write_text(f"""[FEND]
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
FENDCONF ={tmp / "fend.ini"}
[CHANNEL]
NCH      =1
PRN      ={PRN}
SYS      =1
CTYPE    =1
FTYPE    =1
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={tmp}/out
""")
    return tmp, ini


def _run(ini, pipeline: bool, tmp=None) -> dict:
    """The receiver run to the capture's end by ``step_block``: its
    summary, each block's stage, and (pipelined, ``tmp`` given) the
    chrome trace of ``PROFILED`` steady blocks under ``torch.profiler``
    with the dispatch numbers of those blocks."""
    cfg = load_ini(str(ini))
    rx = Receiver(cfg, FileFrontend(cfg.files[0], cfg.fends[0]),
                  device="cpu", pipeline=pipeline)
    end = rx.end_sample()
    stages, trace, traced = [], None, []
    while rx.can_step(end):
        if tmp is not None and trace is None and stages[-1:] == ["steady"]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(PROFILED):
                    traced.append(rx._ndisp + 1)
                    rx.step_block()
                    stages.append(rx.spans.stage)
            trace = str(tmp / f"trace_{pipeline}.json")
            prof.export_chrome_trace(trace)
            continue
        rx.step_block()
        stages.append(rx.spans.stage)
    s = rx.run_seconds()            # nothing left to step: the flush
    rx.close()
    return dict(rx=rx, summary=s, stages=stages, trace=trace,
                traced=traced)


@pytest.fixture(scope="module")
def runs(capture):
    tmp, ini = capture
    return {True: _run(ini, True, tmp), False: _run(ini, False)}


def _rows(run, stage):
    return run["summary"]["spans"]["stages"].get(stage, {})


def test_every_span_per_stage(runs):
    """Each span appears; per stage, the per-block spans count that
    stage's blocks, every dispatched block is collected once, and the
    run reached every stage and its epochs."""
    run = runs[True]
    stab = run["summary"]["spans"]["stages"]
    seen = {name for rows in stab.values() for name in rows}
    assert NAMES <= seen
    assert run["rx"].epochs_written > 0
    nblocks = {st: run["stages"].count(st)
               for st in ("acquire", "pullin", "steady")}
    assert all(nblocks.values())
    for st, nb in nblocks.items():
        rows = stab[st]
        for name in PER_BLOCK + (PER_TRACK if st != "acquire" else ()):
            assert rows[name]["n"] == nb, (st, name)
    dispatched = nblocks["pullin"] + nblocks["steady"]
    assert sum(stab[st].get("track.collect", {}).get("n", 0)
               for st in stab) == dispatched
    assert run["rx"]._ndisp == dispatched


@pytest.mark.parametrize("pipeline", [True, False])
def test_children_within_parents(runs, pipeline):
    """In every stage the children's totals stay within their parent's,
    and self time is the total less the children's."""
    for st, rows in runs[pipeline]["summary"]["spans"]["stages"].items():
        kids = {}
        for name, r in rows.items():
            assert r["self_s"] <= r["s"] + 1e-12
            if r["parent"] is not None:
                kids.setdefault(r["parent"], []).append(r["s"])
        for parent, ss in kids.items():
            if parent in rows:
                assert sum(ss) <= rows[parent]["s"] + 1e-9, (st, parent)
                assert rows[parent]["self_s"] == pytest.approx(
                    rows[parent]["s"] - sum(ss), abs=1e-9)


@pytest.mark.parametrize("pipeline", [True, False])
def test_stage_spans_are_stage_wall(runs, pipeline):
    """The step_block span of each stage is the receiver's stage_wall."""
    run = runs[pipeline]
    wall = run["summary"]["stage_wall"]
    for st in ("acquire", "pullin", "steady"):
        got = _rows(run, st).get(spans.STEP, {}).get("s", 0.0)
        assert got == wall[st], st
    assert _rows(run, "steady")[spans.STEP]["n"] == \
        run["stages"].count("steady")


def test_pipelined_and_sequential_same_names(runs):
    """Both schedules open the same spans (the sequential receiver
    decides its first search inside its first tracking block, so it has
    no acquire stage, and collects every block inside its step)."""
    def names(run):
        return {n for rows in run["summary"]["spans"]["stages"].values()
                for n in rows}
    assert names(runs[True]) == names(runs[False])
    assert set(_rows(runs[False], "steady")) == \
        set(_rows(runs[True], "steady"))


def test_profiler_ranges_nest_in_step_block(runs):
    """Under torch.profiler each span is a gnss.* range inside its
    block's gnss.step_block#<n>; the pipelined collect carries the
    number of the block it collects (pipeline_depth back)."""
    run = runs[True]
    with open(run["trace"]) as f:
        ev = [e for e in json.load(f)["traceEvents"]
              if str(e.get("name", "")).startswith(spans.PREFIX)
              and "dur" in e]
    steps = [e for e in ev if e["name"].startswith("gnss.step_block#")]
    assert [int(e["name"].split("#")[1]) for e in steps] == run["traced"]
    depth = run["rx"].pipeline_depth
    inner = [e for e in ev if e not in steps]
    assert {e["name"].split("#")[0][len(spans.PREFIX):] for e in inner} \
        >= {"acq.collect", "track.dispatch", "track.collect", "nav",
            "obs.epoch", "place"}
    for e in inner:
        host = [s for s in steps if s["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert len(host) == 1, e["name"]
        n = int(host[0]["name"].split("#")[1])
        if e["name"].startswith("gnss.track.collect#"):
            assert int(e["name"].split("#")[1]) == n - depth
        if e["name"].startswith("gnss.track.dispatch#"):
            assert int(e["name"].split("#")[1]) == n


@pytest.mark.parametrize("pipeline", [True, False])
def test_ready_counts_beside_the_waits(runs, pipeline):
    """Each stage that collects a tracking block or a search counts its
    ready collects beside the wait (``track.ready``, ``acq.ready``), never
    more than it collects; on the CPU every collect is ready."""
    stab = runs[pipeline]["summary"]["spans"]["stages"]
    seen = set()
    for st, rows in stab.items():
        for kind in ("track", "acq"):
            wait = rows.get(f"{kind}.wait")
            ready = rows.get(f"{kind}.ready")
            assert (wait is None) == (ready is None), (st, kind)
            if wait is None:
                continue
            seen.add(kind)
            assert ready["n"] == wait["n"], (st, kind)
            assert ready["parent"] == f"{kind}.wait"
            assert spans.ready_of(rows, f"{kind}.ready") == (wait["n"],) * 2
    assert seen == {"track", "acq"}
    assert "track.ready" in stab["steady"] and "track.ready" in stab["pullin"]
    line = spans.split_line(runs[pipeline]["summary"]["spans"])
    n = stab["steady"]["track.wait"]["n"]
    assert f"track.ready {n}/{n}" in line


@pytest.mark.parametrize("pipeline", [True, False])
def test_no_device_spans_on_the_cpu(runs, pipeline):
    """No dev.* entry exists on the CPU; the build's split is there with
    no graph pool."""
    tab = runs[pipeline]["summary"]["spans"]
    assert not [n for rows in tab["stages"].values() for n in rows
                if n.startswith("dev.")]
    build = tab["stages"]["build"]
    assert build["build"]["n"] == 1
    assert build["build.capture"]["n"] == tab["counters"][
        "build.programs"] == 2
    assert tab["counters"]["build.pool_bytes"] == 0


def test_profile_receiver_table(runs):
    """profile_receiver prints each stage's spans with their counts."""
    lines = profile_receiver.table(runs[True]["summary"]["spans"])
    assert any(ln.strip().startswith("[steady]") for ln in lines)
    assert any(ln.split()[0] == "obs.hist" for ln in lines
               if ln.startswith("    "))
    ready = [ln.split() for ln in lines if ln.startswith("    track.ready")]
    assert ready and all(r[-1] == "(100.0%)" for r in ready)
    assert "steady, ms per block of" in spans.split_line(
        runs[True]["summary"]["spans"])


def test_table_bookkeeping():
    """Made-up spans: nesting, the stage chosen at the block's end, a
    block that raises (stage other), measured adds and the merge."""
    tab = spans.SpanTable()
    with tab.step(1):
        with tab("a"):
            with tab("b"):
                pass
        tab.add("dev.x", "pullin", 0.25)
        tab.stage = "steady"
    with pytest.raises(ValueError):
        with tab.step(2):
            with tab("a"):
                raise ValueError
    with tab("c"):
        pass
    tab.add("build", "build", 1.0)
    tab.add("build.capture", "build", 0.4, n=2, parent="build")
    t = tab.table()
    st = t["stages"]
    assert st["steady"]["a"]["parent"] == "step_block"
    assert st["steady"]["b"]["parent"] == "a"
    assert st["steady"]["step_block"]["s"] == tab.stage_wall["steady"]
    assert st["other"]["a"]["n"] == 1 and st["other"]["c"]["n"] == 1
    assert st["other"]["step_block"]["n"] == 1
    assert st["pullin"] == {"dev.x": dict(n=1, s=0.25, self_s=0.25,
                                          parent=None)}
    assert st["build"]["build"]["self_s"] == pytest.approx(0.6)
    assert tab.open is tab.root and tab.slot == spans.STAGES.index("other")
    m = spans.merge([t, t])
    assert m["stages"]["build"]["build.capture"]["n"] == 4
    assert m["stages"]["steady"]["a"]["s"] == 2 * st["steady"]["a"]["s"]


def test_null_table_and_handles():
    """An engine outside a receiver records nothing; a handle is a plain
    tuple on the CPU, with no device time."""
    with spans.NULL("x").at(3):
        pass
    spans.NULL.add("dev.track", "steady", 1.0)
    h = spans.timed([1, 2], spans.DeviceTimer.start(torch.device("cpu")))
    assert type(h) is tuple and h == (1, 2)
    assert spans.device_seconds(h) is None


def test_summary_carries_the_table(runs):
    """run_seconds' summary carries the span table as plain numbers."""
    tab = runs[True]["summary"]["spans"]
    json.dumps(tab)
    assert set(tab["stages"]) >= {"acquire", "pullin", "steady", "other",
                                  "build"}


# --------------------------------------------------------------- SBAS
# one GPS L1CA and one SBAS channel (rxbench.sky's sky of seed 3000000403
# of rxbench/traffic/sbas_long.json, PRN 3 and 133) from a capture file,
# built as profile_receiver --ini builds it (the CLI's build_receiver):
# two channel groups in a MultiReceiver, the SBAS messages on the stream
SBAS_SEED, SBAS_PRNS, SBAS_SECONDS = 3000000403, (3, 133), 10.0


@pytest.fixture(scope="module")
def sbas_run(tmp_path_factory):
    import os
    from rxbench import sky
    tmp = tmp_path_factory.mktemp("torch_spans_sbas")
    with open(os.path.join(os.path.dirname(sky.__file__), "traffic",
                           "sbas_long.json")) as f:
        mix = json.load(f)
    sk = sky.draw_sky(mix, np.random.default_rng([SBAS_SEED, 0]),
                      mix["seconds"])
    sk.signals = [s for s in sk.signals if s.prn in SBAS_PRNS]
    sky.synthesize(sk, F_SF, F_IF, int(SBAS_SECONDS * F_SF), device="cpu",
                   noise_seed=5).numpy().tofile(tmp / "capture.bin")
    (tmp / "fend.ini").write_text(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={F_SF}
IF1      ={F_IF}
DTYPE1   =1
FILE1    ={tmp / "capture.bin"}
[TRACK]
CORRN    =2
CORRD    =2
CORRP    =2
""")
    ini = tmp / "rx.ini"
    ini.write_text(f"""[RCV]
FENDCONF ={tmp / "fend.ini"}
[CHANNEL]
NCH      =2
PRN      =3,133
SYS      =1,2
CTYPE    =1,27
FTYPE    =1,1
[OUTPUT]
OUTMS    =400
RINEX    =0
SBAS     =1
SBASPORT =0
""")
    rx = profile_receiver._configured(str(ini), "cpu", True, 400)
    sent = bytearray()
    send = rx.hub.sbas_srv.send

    def keep(b):
        sent.extend(b)
        send(b)
    rx.hub.sbas_srv.send = keep
    s = rx.run_seconds()
    profile_receiver._close(rx)
    return dict(rx=rx, summary=s, sbas=bytes(sent), sky=sk)


def _sbas_group(run):
    """(index, summary) of the run's group with the SBAS channel."""
    return next((k, g) for k, (g, r) in enumerate(zip(
        run["summary"]["groups"], run["rx"].rx))
        if any(c.cfg.prn == 133 for c in r.channels))


def test_sbas_spans_and_counters(sbas_run):
    """The SBAS group's table has nav.fec under nav and sbas.send under
    track.collect, and sbas.frames counts the frames on the stream; the
    GPS group has none of them."""
    from rxbench import truth
    k, g = _sbas_group(sbas_run)
    frames = truth.parse_novatel_sbas(sbas_run["sbas"])
    assert frames
    tab = g["spans"]
    assert tab["counters"]["sbas.frames"] == len(frames)
    assert tab["counters"]["sbas.crc_fail"] == 0
    rows = {}                   # every stage's, the final flush's too
    for st_rows in tab["stages"].values():
        for name, r in st_rows.items():
            rows.setdefault(name, []).append(r)
    assert {r["parent"] for r in rows[spans.FEC]} == {"nav"}
    assert {r["parent"] for r in rows[spans.SBAS_SEND]} == {"track.collect"}
    assert sum(r["n"] for r in rows[spans.SBAS_SEND]) == len(frames)
    # a predecode per symbol while it searched, one a message after
    assert sum(r["n"] for r in rows[spans.FEC]) > len(frames)
    gps = sbas_run["summary"]["groups"][1 - k]["spans"]
    assert not set(spans.SBAS_COUNTERS) & set(gps["counters"])
    assert not {n for rows_ in gps["stages"].values() for n in rows_} & {
        spans.FEC, spans.SBAS_SEND}
    merged = sbas_run["summary"]["spans"]
    assert merged["counters"]["sbas.frames"] == len(frames)
    line = spans.split_line(merged)
    assert f"sbas.frames {len(frames)}" in line and "sbas.crc_fail 0" in line
    assert spans.FEC in line


def test_profile_receiver_shows_the_sbas_group(sbas_run):
    """profile_receiver prints each group's table; the SBAS group's has
    its spans and counters."""
    k, _ = _sbas_group(sbas_run)
    lines = profile_receiver.tables(sbas_run["summary"])
    heads = [i for i, ln in enumerate(lines) if ln.startswith(" group ")]
    assert len(heads) == 2
    end = heads[k + 1] if k + 1 < len(heads) else len(lines)
    body = lines[heads[k]:end]
    names = {ln.split()[0] for ln in body if ln.startswith("    ")}
    assert {spans.FEC, spans.SBAS_SEND} <= names
    assert any(ln.strip().startswith("sbas.frames ") for ln in body)
    assert any(ln.strip().startswith("sbas.crc_fail ") for ln in body)


def test_sbas_crc_fail_counts_a_corrupted_run():
    """An SBAS framer fed a symbol stream whose first messages carry a
    run of 24 inverted symbols mid-body (past what the K=7 code corrects,
    their preambles intact): each such message whose preamble pair it
    matches counts in sbas.crc_fail, and the first clean one frames."""
    from rxbench import sky
    from gnsslib_tpu_torch.constants import CodeType
    from gnsslib_tpu_torch.nav import NavChannel
    msgs = sky.sbas_messages(9.0, np.random.default_rng(7), -1)

    def run(bad: int):
        sym = sky.sbas_symbols(msgs).astype(np.float64)
        for k in range(bad):
            sym[500 * k + 200:500 * k + 224] *= -1.0
        ip = np.repeat(sym, 2) * 1000.0
        nav = NavChannel(CodeType.L1SBAS, 133)
        tab = spans.SpanTable()
        pre = []
        for c0 in range(0, len(ip), 400):
            evs = nav.update(ip[c0:c0 + 400],
                             np.arange(c0, c0 + 400) * 4092, c0, tab)
            pre += [e.cnt for e in evs if e.kind == "preamble"]
        return tab, pre
    tab, pre = run(0)
    assert tab.counters.get("sbas.crc_fail", 0) == 0 and pre
    clean = pre[0]
    tab, pre = run(6)
    assert tab.counters["sbas.crc_fail"] >= 1
    assert pre and pre[0] > clean
    rows = tab.table()["stages"]["other"]
    assert rows[spans.FEC]["n"] > 0
