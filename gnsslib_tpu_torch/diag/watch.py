"""Operator terminal dashboard (``--watch``): the port's own copy of
:mod:`gnsslib_tpu.diag.watch`, with the same output.

The reference streams acquisition surfaces / correlator shapes / spectra
to interactive gnuplot windows during the run (src/sdrplot.c:336-394,
driven from the main loop src/sdrmain.c:258-299).  A headless run has no
display server, so the operator-facing live view is a terminal dashboard
instead: one table of lock / C/N0 / Doppler / nav / observable state per
channel, refreshed at the SPEC_MS cadence of STREAM time.

Built exclusively over host-side telemetry the receiver already fetched
(ChannelRuntime flags, the per-block dcarr/prompt shadows, OutputHub
counters): a dashboard must never read a device tensor, which would wait
for every tracking block queued on the card.
"""
from __future__ import annotations

import sys

from ..constants import SPEC_MS, CodeType

_STATE_ORDER = ("idle", "pull-in", "track", "nav")


def _chan_state(ch) -> str:
    if not ch.locked:
        return "idle"
    if not ch.synced:
        return "pull-in"
    if not ch.nav.flagdec:
        return "track"
    return "nav"


def channel_rows(parts) -> list[dict]:
    """One dict per channel across all front-end groups (host-side
    fields only)."""
    rows = []
    for r in parts:
        for ch in r.channels:
            tow = None
            if getattr(ch.hist, "nrec", 0) > 0:
                tow = float(ch.hist.tow[0])
            rows.append(dict(
                prn=ch.cfg.prn,
                ctype=CodeType(ch.cfg.ctype).name,
                ftype=ch.cfg.ftype,
                state=_chan_state(ch),
                cn0=float(ch.cn0),
                dopp=float(getattr(ch, "dcarr_live", 0.0)),
                prompt=float(getattr(ch, "prompt_live", 0.0)),
                tow=tow,
            ))
    return rows


def render_text(rx, t: float) -> str:
    """The full dashboard frame as plain text (no ANSI — the CLI adds
    cursor control; tests assert on this string)."""
    parts = getattr(rx, "rx", [rx])
    rows = channel_rows(parts)
    locked = sum(r["state"] != "idle" for r in rows)
    dec = sum(r["state"] == "nav" for r in rows)
    hub = getattr(rx, "hub", None)
    lines = [
        f"erlang-gnss-tpu  t={t:8.1f} s   locked {locked}/{len(rows)}   "
        f"decoded {dec}   epochs {rx.epochs_written}   "
        f"eph {getattr(hub, 'ephs_written', 0)}",
        f"{'PRN':>4} {'SIG':<7} {'STATE':<8} {'C/N0':>5} "
        f"{'DOPPLER':>9} {'PROMPT':>9} {'TOW':>10}",
    ]
    for r in rows:
        tow = f"{r['tow']:10.1f}" if r["tow"] is not None else f"{'-':>10}"
        cn0 = f"{r['cn0']:5.1f}" if r["state"] != "idle" else f"{'-':>5}"
        dop = (f"{r['dopp']:+9.1f}" if r["state"] != "idle"
               else f"{'-':>9}")
        pr = (f"{r['prompt']:9.0f}" if r["state"] in ("track", "nav")
              else f"{'-':>9}")
        lines.append(f"{r['prn']:>4} {r['ctype']:<7} {r['state']:<8} "
                     f"{cn0} {dop} {pr} {tow}")
    if hub is not None and getattr(hub, "positions", None):
        import math
        from ..obs.spp import ecef2llh
        wk, tow, pos, clk, nsat = hub.positions[-1]
        lat, lon, h = ecef2llh(pos)
        lines.append(f" spp tow={tow:9.1f} lat={math.degrees(lat):.6f} "
                     f"lon={math.degrees(lon):.6f} h={h:.1f} m "
                     f"({nsat} sats)")
    evs = []
    for r in parts:
        evs.extend(r.events)
    for e in evs[-3:]:
        lines.append(" event: " + " ".join(str(x) for x in e))
    return "\n".join(lines) + "\n"


class Watch:
    """Throttled ANSI renderer: call ``tick(t)`` from the receiver's
    progress callback; redraws every SPEC_MS of stream time (the
    reference specthread cadence, src/sdrspec.c:29-110)."""

    def __init__(self, rx, out=None, interval_s: float = SPEC_MS / 1000.0):
        self.rx = rx
        self.out = out if out is not None else sys.stdout
        self.interval = float(interval_s)
        self._next_t = 0.0
        self._nlines = 0

    def tick(self, t: float) -> None:
        if t < self._next_t:
            return
        self._next_t = t + self.interval
        text = render_text(self.rx, t)
        # clamp to the terminal height: a frame taller than the screen
        # scrolls as it prints, the cursor-up then under-shoots the
        # frame start, and every refresh smears stale rows into the
        # scrollback (32 channels > a 24-row terminal)
        rows = 0
        try:
            import os
            rows = os.get_terminal_size(self.out.fileno()).lines
        except (OSError, ValueError, AttributeError):
            pass
        lines = text.splitlines()
        if rows and len(lines) > rows - 1:
            kept = max(rows - 2, 1)
            lines = lines[:kept] + [f" … {len(lines) - kept} more rows "
                                    f"(enlarge the terminal)"]
            text = "\n".join(lines) + "\n"
        n = text.count("\n")
        # move up over the previous frame and overwrite in place
        # (no full-screen clear: scrollback above the table survives)
        up = f"\x1b[{self._nlines}F" if self._nlines else ""
        self.out.write(up + "\x1b[J" + text)
        self.out.flush()
        self._nlines = n

    def close(self) -> None:
        self.out.flush()
