"""The port stands without JAX and without the JAX package, and its chip
smoke script refuses to run without a CUDA card."""
import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# refuse ``jax`` and the JAX package ``gnsslib_tpu`` (not the port,
# ``gnsslib_tpu_torch``) in the process that runs the code after it
BLOCK_JAX = textwrap.dedent("""
    import importlib.abc, sys

    def _blocked(name):
        return (name in ("jax", "gnsslib_tpu")
                or name.startswith(("jax.", "jaxlib", "gnsslib_tpu.")))

    class _NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if _blocked(name):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, _NoJax())
    for m in [m for m in sys.modules if _blocked(m)]:
        del sys.modules[m]
""")


def _run(code, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_tracks_without_jax():
    """Every module of the port imports with ``jax`` and ``gnsslib_tpu``
    blocked, and a short Tracker block plus a FastTracker block run on the
    CPU from a capture the port's own ``sim`` synthesizes."""
    code = BLOCK_JAX + textwrap.dedent("""
        import pkgutil, importlib, numpy as np, torch
        torch.set_num_threads(2)
        import gnsslib_tpu_torch
        for m in pkgutil.walk_packages(gnsslib_tpu_torch.__path__,
                                       "gnsslib_tpu_torch."):
            importlib.import_module(m.name)
        from gnsslib_tpu_torch import sim
        from gnsslib_tpu_torch.constants import CodeType, DType
        from gnsslib_tpu_torch.track import (FastTracker, TrackConfig,
                                             Tracker)
        f_sf = 4.092e6
        ch = sim.SimChannel(prn=7, doppler=900.0,
                            code_phase=-800 * 1.023e6 / f_sf)
        x = sim.synthesize([ch], f_sf, 1.023e6, DType.REAL, 200000, seed=1)
        block = torch.from_numpy(np.asarray(x, np.float32))
        trk = Tracker(TrackConfig(4, 2, 2), [7], [CodeType.L1CA], f_sf,
                      1.023e6, DType.REAL, device="cpu")
        st = trk.start_channels(trk.init_state(), [0], [800], [-900.0])
        st, out = trk.run_block(st, block, 20)
        st = trk.set_bit_sync(st, 0, 0)
        st, out2 = FastTracker(trk).run_block(st, block, 20)
        assert np.all(np.diff(out.loc[:, 0]) > 0) and out2.ip.shape == (20, 1)
        assert not any(_blocked(m) for m in sys.modules)
        print("NOJAX OK")
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX OK" in r.stdout


def test_live_and_native_modules_without_jax():
    """The modules of the live path and the native host kernels (native,
    io.live, the four driver bindings, the live cache) import and run with
    ``jax`` and ``gnsslib_tpu`` blocked; the port's native library is
    built under build/gnsslib_tpu_torch/ and the JAX package's library
    is never loaded."""
    code = BLOCK_JAX + textwrap.dedent("""
        import importlib, os, sys, time, numpy as np, torch
        torch.set_num_threads(2)
        for m in ("native", "io.live", "io.rtlsdr", "io.bladerf",
                  "io.gn3s", "io.stereo", "io.devcache"):
            importlib.import_module("gnsslib_tpu_torch." + m)
        from gnsslib_tpu_torch import native
        from gnsslib_tpu_torch.constants import DType, FrontendType
        from gnsslib_tpu_torch.io import ProcessFrontend
        from gnsslib_tpu_torch.io.devcache import block_cache
        from gnsslib_tpu_torch.io.frontend import FrontendSpec
        assert native.available()
        lib = native.library_path()
        assert lib.parent == (__import__("pathlib").Path(os.getcwd())
                              / "build" / "gnsslib_tpu_torch"), lib
        sym = np.random.default_rng(3).integers(0, 256, 200)
        assert native.viterbi27_decode(sym, 100).shape == (100,)
        spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                            f_sf=4.092e6, f_if=1.023e6, dtype=DType.REAL)
        argv = [sys.executable, "-c",
                "import sys; sys.stdout.buffer.write(bytes(range(1, 201)))"]
        with ProcessFrontend(argv, spec, timeout_s=5.0) as fe:
            cache = block_cache(fe, device="cpu", span=64)
            deadline = time.time() + 10
            while not fe.eof and time.time() < deadline:
                time.sleep(0.02)
            x = cache.get(-8, 64).numpy()
        assert (x[:8] == 0).all() and (x[8:] == np.arange(1, 57)).all()
        maps = open("/proc/self/maps").read()
        assert str(lib) in maps
        assert "gnsslib_tpu/native/" not in maps
        assert not any(_blocked(m) for m in sys.modules)
        print("LIVE NOJAX OK")
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LIVE NOJAX OK" in r.stdout


def test_diag_modules_without_jax_or_matplotlib():
    """The diagnostics (spectrum, monitor, watch, htmlview, plots) import
    and run with ``jax``, ``gnsslib_tpu`` and ``matplotlib`` blocked (the
    card's machine has no matplotlib): the monitor makes a frame on the
    CPU, the dashboards render, and every plot returns None."""
    code = BLOCK_JAX + textwrap.dedent("""
        import importlib, io, numpy as np, torch
        torch.set_num_threads(2)

        class _NoMpl(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "matplotlib":
                    raise ImportError(f"{name} is blocked in this process")
        sys.meta_path.insert(0, _NoMpl())
        for m in ("spectrum", "monitor", "watch", "htmlview", "plots"):
            importlib.import_module("gnsslib_tpu_torch.diag." + m)
        from gnsslib_tpu_torch.diag import SpectrumMonitor, plots
        from gnsslib_tpu_torch.diag.htmlview import render_html
        from gnsslib_tpu_torch.diag.watch import render_text

        class Tone:
            def read(self, start, n):
                t = (start + np.arange(n)) / 16.368e6
                return np.round(30 * np.cos(2 * np.pi * 4.092e6 * t)
                                ).astype(np.float32)
        mon = SpectrumMonitor(Tone(), 16.368e6, False, device="cpu")
        mon.maybe_update(int(0.5 * 16.368e6))
        f = mon.latest
        assert abs(f.freq_hz[np.argmax(f.pspec_db)] - 4.092e6) < 2e3
        rx = type("Rx", (), dict(channels=[], events=[], epochs_written=0,
                                 spec_monitor=mon, acq_views={},
                                 corr_views={}))()
        assert "locked 0/0" in render_text(rx, 0.5)
        assert "IF spectrum" in render_html(rx, 0.5, 0.2)
        assert plots.plot_spectrum(f.freq_hz, f.pspec_db, "x.png") is None
        assert plots.plot_histogram(f.hist_edges, f.hist_counts,
                                    "x.png") is None
        assert plots.plot_acq_surface(np.ones((3, 4)), np.arange(3.0),
                                      "x.png") is None
        assert plots.plot_correlator(np.arange(3), np.ones(3),
                                     "x.png") is None
        assert not any(_blocked(m) or m.startswith("matplotlib")
                       for m in sys.modules)
        print("DIAG NOJAX OK")
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DIAG NOJAX OK" in r.stdout


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py and every module its phases import load with ``jax``
    and ``gnsslib_tpu`` blocked (the modules are read from its source, so
    a new phase's imports are covered too)."""
    code = BLOCK_JAX + textwrap.dedent("""
        import ast, importlib
        tree = ast.parse(open("chip_smoke.py").read())
        mods = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update((a.name, ()) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.setdefault(node.module, ())
                mods[node.module] += tuple(a.name for a in node.names)
        assert any(m.startswith("gnsslib_tpu_torch.") for m in mods), mods
        import chip_smoke
        for m, names in sorted(mods.items()):
            mod = importlib.import_module(m)
            for n in names:                 # as ``from m import n`` does
                if not hasattr(mod, n):
                    importlib.import_module(f"{m}.{n}")
        assert not any(_blocked(m) for m in sys.modules)
        print("SMOKE IMPORTS OK", len(mods))
    """)
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SMOKE IMPORTS OK" in r.stdout


def test_chip_smoke_refuses_without_cuda():
    """Here there is no card: the script must exit nonzero and print no
    success line."""
    if torch.cuda.is_available():                     # pragma: no cover
        return
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository the script fails without a success line."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
