"""Command line of the port — file replay and live capture on a CUDA card
(or the CPU).

Usage:
    python -m gnsslib_tpu_torch <config.ini> [--device {cuda,cpu}]
        [--seconds N] [--nsteps N] [--devices N] [--ftype {0,1,2}]
        [--quiet] [--spp]
        [--spec] [--watch] [--watch-html PATH] [--profile DIR]
        [--checkpoint PATH] [--resume PATH]

Every RF path with configured channels is processed (``--ftype`` picks
one): one file front end per path (``TYPE=FILE`` with ``FILE1``/``FILE2``,
or a packed two-path format such as ``FILESTEREO`` whose paths both read
``FILE1``), and the channels grouped by path and loop cadence
(:func:`~.receiver.build_receiver`).  A live FEND type (``TYPE=RTLSDR``,
``BLADERF``, ``GN3SV2``, ``GN3SV3`` or ``STEREO``) opens the in-process
driver binding of :mod:`..io` instead, its vendor library located through
``GNSSLIB_RTLSDR_LIB``, ``GNSSLIB_BLADERF_LIB``, ``GNSSLIB_GN3S_LIB`` or
``GNSSLIB_STEREO_LIB`` (then the system's library paths), and the run
streams through ``run_live`` until the stream ends, ``--seconds`` or a
stop; a binding that fails to load ends the run with exit code 1.

``--spec`` (or ``[SPECTRUM] SPEC=1``) writes the spectrum and histogram
of the first second to ``spectrum.npz`` under RINEXPATH (PNG plots too
where matplotlib is installed) and runs the receiver's live spectrum
monitor; ``--watch`` draws the terminal dashboard, ``--watch-html PATH``
rewrites a self-refreshing HTML page (and implies SPEC), both at the
SPEC_MS cadence of stream time; ``--profile DIR`` writes a
``torch.profiler`` trace of the run (CPU and CUDA activities) into DIR
for Chrome or TensorBoard.

``--device cuda`` (the default) requires a CUDA card and never falls back
to the CPU.  ``--devices N`` (N > 1) shards the channels over N devices
(:mod:`..parallel`): the first N cards with ``--device cuda`` (fewer cards
end the run with ``need N devices, have k`` and exit code 1), N CPU
shards with ``--device cpu``.  SIGINT, SIGTERM and 'q' on a terminal stop
the run at the next block boundary: the blocks in flight are collected,
RINEX closes complete and ``--checkpoint`` is still written; a second
signal forces the exit.
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import threading

import torch

from ..constants import FrontendType as FT
from ..io.frontend import FileFrontend
from ..obs.spp import ecef2llh
from .config import LIVE_FENDS, load_ini
from .receiver import build_receiver

# flags of `python -m gnsslib_tpu` that the port does not carry yet
UNPORTED_FLAGS = ()


def _make_live_frontend(spec, built: list):
    """The in-process driver of a live FEND type (the reference's rcvinit
    dispatch, src/sdrrcv.c:20-90).  The STEREO second RF path is a view
    over FE1's byte stream (both paths are packed in one byte,
    src/rcv/stereo/stereo.c:160-205)."""
    if spec.fend == FT.STEREO:
        from ..io.stereo import StereoFrontend
        for fe in built:                     # FE2 rides FE1's ring
            if isinstance(fe, StereoFrontend):
                return fe.fe2(spec)
        return StereoFrontend(spec)
    if spec.fend == FT.RTLSDR:
        from ..io.rtlsdr import RtlSdrFrontend
        return RtlSdrFrontend(spec)
    if spec.fend == FT.BLADERF:
        from ..io.bladerf import BladeRfFrontend
        return BladeRfFrontend(spec)
    from ..io.gn3s import Gn3sFrontend
    return Gn3sFrontend(spec)


def _install_stop_handlers(rx, quiet: bool):
    """Graceful interruption (the reference's keythread 'q' -> stopflag
    -> quitsdr teardown, src/sdrmain.c:59-80,190-218): SIGINT/SIGTERM —
    and 'q' on a tty — ask ``rx`` to stop at the next block boundary, so
    the blocks in flight flush and the RINEX/pos writers close complete.
    A second signal raises ``KeyboardInterrupt`` (a forced exit).  Returns
    a function that puts back the previous handlers and terminal mode."""
    seen = []

    def _handler(signum, frame):
        if seen:
            raise KeyboardInterrupt
        seen.append(signum)
        if not quiet:
            print("\nstopping: flushing the blocks in flight and closing "
                  "outputs (signal again to force quit)", file=sys.stderr)
        rx.request_stop()

    previous = {}
    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            previous[s] = signal.signal(s, _handler)
        except ValueError:                 # not the main thread
            break
    term = None                            # (fd, saved tty attributes)
    if previous and sys.stdin is not None and sys.stdin.isatty():
        # cbreak delivers 'q' at once (a canonical-mode tty would buffer it
        # until Enter); set and restored from the main thread, since the
        # reader may stay blocked in read() after the run
        import termios
        import tty
        fd = sys.stdin.fileno()
        try:
            term = (fd, termios.tcgetattr(fd))
            tty.setcbreak(fd)
        except termios.error:
            pass

        def _keys():
            while not rx.stop_requested:
                try:
                    c = sys.stdin.read(1)
                except (OSError, ValueError):
                    return
                if not c:
                    return                  # stdin EOF
                if c.lower() == "q":
                    rx.request_stop()
                    return
        threading.Thread(target=_keys, daemon=True).start()

    def restore():
        if term is not None:
            import termios
            termios.tcsetattr(term[0], termios.TCSADRAIN, term[1])
        for s, h in previous.items():
            signal.signal(s, h)
    return restore


def _spectrum_views(rx, fe, cfg, device, quiet: bool) -> None:
    """The reference spectrum analyzer view (src/sdrspec.c) of the first
    second of IF data into ``spectrum.npz`` (and PNGs with matplotlib)
    under RINEXPATH; with matplotlib, the live monitor's frames, the
    acquisition surfaces and the correlator shapes refresh PNGs there
    during the run (a file-based stand-in for the gnuplot windows)."""
    import numpy as np
    from ..diag import sample_histogram, welch_spectrum
    from ..diag.plots import (plot_acq_surface, plot_correlator,
                              plot_histogram, plot_spectrum)
    spec = fe.spec
    x = fe.read(0, min(int(spec.f_sf), fe.nsamples))
    outdir = cfg.rinexpath
    os.makedirs(outdir, exist_ok=True)
    freq, pdb = welch_spectrum(x, spec.f_sf, iq=x.ndim == 2, device=device)
    # bin width by front-end quantization: 8-bit formats get the full byte
    # range, 2/3-bit LUT formats the reference's 3-bit view
    nbit = 8 if spec.fend in (FT.FILE, FT.RTLSDR, FT.FRTLSDR, FT.BLADERF,
                              FT.FBLADERF) else 3
    edges, counts = sample_histogram(x, nbit=nbit)
    np.savez(os.path.join(outdir, "spectrum.npz"), freq=freq, pdb=pdb,
             edges=edges, counts=counts)
    p1 = plot_spectrum(freq, pdb, os.path.join(outdir, "spectrum.png"))
    p2 = plot_histogram(edges, counts, os.path.join(outdir, "histogram.png"))
    if not quiet:
        print(f"spectrum diagnostics: {outdir}/spectrum.npz"
              + (f", {p1}, {p2}" if p1 else " (matplotlib absent)"))
    parts = getattr(rx, "rx", [rx])
    mons = [r.spec_monitor for r in parts if r.spec_monitor is not None]
    if not (mons and p1):
        return
    nseen = [0]

    def live_view(frame):
        # every 5th frame (~1 s of stream)
        nseen[0] += 1
        if nseen[0] % 5:
            return
        plot_spectrum(frame.freq_hz, frame.pspec_db,
                      os.path.join(outdir, "spectrum_live.png"))
        plot_histogram(frame.hist_edges, frame.hist_counts,
                       os.path.join(outdir, "histogram_live.png"))
        # correlator tap shapes (reference plttrk, src/sdrmain.c:293-299)
        for r in parts:
            for prn, cv in r.corr_views.items():
                plot_correlator(cv["offsets"], cv["mag"],
                                os.path.join(outdir, f"corr_{prn:02d}.png"),
                                title=f"PRN {prn} taps @ {cv['t']:.1f}s")
    mons[0].on_frame = live_view

    def acq_view(ch, view):
        # acquisition surface at lock (reference pltacq, sdrmain.c:258-261)
        plot_acq_surface(
            view["surface"], view["dopp_hz"],
            os.path.join(outdir, f"acq_{ch.cfg.prn:02d}.png"),
            title=(f"PRN {ch.cfg.prn} acq @ {view['t']:.1f}s "
                   f"C/N0 {view['cn0']:.1f} dB-Hz"),
            scale=view.get("grid_scale", 1.0), codei=view.get("codei"))
    for r in parts:
        r.on_acq = acq_view


def _profiled(runner, args, progress, device) -> dict:
    """``runner`` under ``torch.profiler`` with CPU (and, on a card, CUDA)
    activities, its trace written into ``args.profile`` for Chrome or
    TensorBoard (the JAX CLI's ``jax.profiler.trace``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(args.profile)):
        return runner(args.seconds, progress=progress)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gnsslib_tpu_torch",
        description="GNSS SDR receiver on PyTorch/CUDA (file replay)")
    ap.add_argument("config", help="gnss-sdrcli-style INI file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the receiver runs (default: cuda)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="limit processing to the first N stream seconds")
    ap.add_argument("--nsteps", type=int, default=400,
                    help="code periods per device block")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the channels over N devices: the first N "
                         "cards (or N CPU shards with --device cpu)")
    ap.add_argument("--ftype", type=int, default=0,
                    help="front-end RF path to process (1 or 2; default "
                         "0 = every path with configured channels)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--spp", action="store_true",
                    help="solve single-point positions per obs epoch "
                         "(also [OUTPUT] SPP=1); writes a .pos file "
                         "alongside RINEX")
    ap.add_argument("--spec", action="store_true",
                    help="write IF spectrum/histogram diagnostics "
                         "(also enabled by [SPECTRUM] SPEC=1)")
    ap.add_argument("--watch", action="store_true",
                    help="live terminal dashboard (lock, C/N0, Doppler, "
                         "nav, epoch table; SPEC_MS refresh) instead of "
                         "the one-line progress counter")
    ap.add_argument("--watch-html", metavar="PATH", default=None,
                    help="graphical live view: rewrite a self-refreshing "
                         "HTML page (channel table + spectrum, acq "
                         "surface, correlator-shape SVGs) at the SPEC_MS "
                         "cadence; implies --spec")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the run (CPU and "
                         "CUDA activities) into DIR")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="save a resumable receiver snapshot at the end")
    ap.add_argument("--resume", metavar="PATH", default=None,
                    help="load a snapshot saved with --checkpoint")
    for flag in UNPORTED_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            raise NotImplementedError(
                f"{flag} is not ported to gnsslib_tpu_torch yet")
    device = torch.device(args.device)
    mesh = None
    if args.devices > 1:
        from ..parallel import make_mesh
        try:
            mesh = (make_mesh(devices=[device] * args.devices)
                    if device.type == "cpu" else make_mesh(args.devices))
        except ValueError as e:
            print(f"error: --devices {args.devices}: {e}", file=sys.stderr)
            return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but torch sees no CUDA card "
              "(use --device cpu to run on the CPU)", file=sys.stderr)
        return 1

    cfg = load_ini(args.config)
    if args.spp:
        cfg.spp = True
    if args.watch_html:
        # the acq/correlator/spectrum views populate only with the monitor
        cfg.spec = True
    if not cfg.fends:
        print("error: config has no front end ([FEND] missing?)",
              file=sys.stderr)
        return 1
    if args.ftype and not 1 <= args.ftype <= len(cfg.fends):
        print(f"error: --ftype {args.ftype} but config defines "
              f"{len(cfg.fends)} front-end path(s)", file=sys.stderr)
        return 1
    ch_ftypes = sorted({c.ftype for c in cfg.channels
                        if c.ftype <= len(cfg.fends)})
    use_ftypes = ([args.ftype] if args.ftype else ch_ftypes) or [1]
    fes = {}

    def close_all():
        for f in fes.values():
            if hasattr(f, "close"):       # a STEREO FE2 view has none
                f.close()
    for ft in use_ftypes:
        spec_ft = cfg.fends[ft - 1]
        if spec_ft.fend in LIVE_FENDS:
            try:
                fes[ft] = _make_live_frontend(spec_ft, list(fes.values()))
            except OSError as e:
                close_all()
                print(f"error: live front end: {e}", file=sys.stderr)
                return 1
            continue
        path = cfg.files[ft - 1] if len(cfg.files) >= ft else ""
        # a packed two-path format carries both RF paths in FILE1
        path = path or (cfg.files[0] if cfg.files else "")
        if not path:
            close_all()
            print("error: no IF file configured (FILE1/FILE2)",
                  file=sys.stderr)
            return 1
        fes[ft] = FileFrontend(path, spec_ft)
    live = any(getattr(f, "is_live", False) for f in fes.values())
    try:
        rx = build_receiver(cfg, fes, device=device,
                            nsteps_per_block=args.nsteps, mesh=mesh)
    except BaseException:
        close_all()
        raise
    if args.resume:
        rx.load_checkpoint(args.resume)
    fe = fes[use_ftypes[0]]
    spec = fe.spec
    if args.spec or cfg.spec:
        _spectrum_views(rx, fe, cfg, device, args.quiet)

    watch = htmlview = None
    if args.watch:
        from ..diag.watch import Watch
        watch = Watch(rx)
    if args.watch_html:
        from ..diag.htmlview import HtmlView
        htmlview = HtmlView(rx, args.watch_html)
        if not args.quiet:
            print(f"live view: file://{os.path.abspath(args.watch_html)}")

    def progress(t):
        if htmlview is not None:
            htmlview.tick(t)
        if watch is not None:
            watch.tick(t)
        elif not args.quiet:
            locked = sum(ch.locked for ch in rx.channels)
            dec = sum(ch.nav.flagdec for ch in rx.channels)
            print(f"\r  t={t:7.1f}s locked={locked} decoded={dec} "
                  f"epochs={rx.epochs_written}", end="", flush=True)

    restore = _install_stop_handlers(rx, args.quiet)
    try:
        if not args.quiet:
            print(f"gnsslib_tpu_torch: {len(rx.channels)} channels in "
                  f"{len(getattr(rx, 'rx', [rx]))} group(s) on "
                  f"{len(fes)} RF path(s) on "
                  f"{device}, f_sf={spec.f_sf/1e6:.3f} MHz, "
                  f"f_if={spec.f_if/1e6:.3f} MHz, "
                  + ("live capture" if live else
                     f"{fe.nsamples/spec.f_sf:.1f} s of IF data"),
                  flush=True)
        runner = rx.run_live if live else rx.run_seconds
        if args.profile:
            stats = _profiled(runner, args, progress, device)
            if not args.quiet:
                print(f"\nprofile: {args.profile}")
        else:
            stats = runner(args.seconds, progress=progress)
        if args.checkpoint:
            rx.save_checkpoint(args.checkpoint)
        if htmlview is not None:
            htmlview.close()            # final frame with the end state
    finally:
        restore()
        rx.close()
        close_all()
    if not args.quiet:
        print()
        for ev in rx.events:
            print("  event:", ev)
        sw = stats["stage_wall"]
        print(f"done: {stats['seconds']:.1f} s in {stats['wall']:.1f} s "
              f"({stats['msps']:.2f} Msamples/s); wall by phase: acquire "
              f"{sw['acquire']:.1f} s, pull-in {sw['pullin']:.1f} s, "
              f"steady {sw['steady']:.1f} s; locked PRNs "
              f"{stats['locked']}, decoded {stats['decoded']}, "
              f"{stats['epochs']} obs epochs, {stats['ephs']} eph records")
        if live:
            print(f"live: largest lag behind the producer "
                  f"{stats['lag']:.3f} s")
        if rx.obs_writer:
            print(f"rinex obs: {rx.obs_writer.path}")
            print(f"rinex nav: {rx.nav_writer.path}")
        if rx.hub.positions:
            wk, tow, pos, clk, nsat = rx.hub.positions[-1]
            lat, lon, h = ecef2llh(pos)
            print(f"spp: {len(rx.hub.positions)} fixes; last "
                  f"tow={tow:.1f} lat={math.degrees(lat):.7f} "
                  f"lon={math.degrees(lon):.7f} h={h:.1f} m "
                  f"({nsat} sats)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
