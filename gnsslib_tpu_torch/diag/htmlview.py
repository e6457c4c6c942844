"""Auto-refreshing HTML live view (``--watch-html PATH``): the port's
own copy of :mod:`gnsslib_tpu.diag.htmlview`, with the same page.

The reference streams acquisition surfaces / correlator shapes / spectra
to interactive gnuplot windows (src/sdrplot.c:336-394, driven from
src/sdrmain.c:258-299).  A headless run has no display server, so
the graphical equivalent is a self-contained HTML page rewritten in
place at the SPEC_MS cadence: open it in any browser (``file://`` is
enough) and it re-reads itself via ``<meta http-equiv=refresh>``.

Everything is inline SVG built from host-side telemetry the receiver
already fetched (channel_rows, acq_views/corr_views, the
SpectrumMonitor's latest frame) — like diag/watch.py, this must never
read a device tensor, which would wait for the queued tracking blocks.

Chart conventions: one series per plot (the title names it, no legend);
the acquisition surface is a single-hue light->dark sequential ramp;
channel-state colors are always paired with the state WORD, never color
alone.
"""
from __future__ import annotations

import html
import os

import numpy as np

from ..constants import SPEC_MS
from .watch import channel_rows

# ink / surface / accent tokens (text never wears series color)
_INK = "#1f2430"
_MUTED = "#5c6470"
_GRID = "#e3e6ea"
_ACCENT = "#2458c5"          # single-series line/marker hue
_STATE_BG = {"idle": "#eceef0", "pull-in": "#fdf0d7",
             "track": "#dbe7fb", "nav": "#d9f0df"}
# sequential ramp for the acquisition power surface (one hue,
# light -> dark; never a rainbow)
_HEAT = ((0.937, 0.949, 0.969), (0.776, 0.831, 0.925),
         (0.545, 0.659, 0.855), (0.302, 0.455, 0.757),
         (0.118, 0.227, 0.541))


def _heat_color(v: float) -> str:
    """v in [0,1] -> hex color on the sequential ramp."""
    x = min(max(v, 0.0), 1.0) * (len(_HEAT) - 1)
    i = min(int(x), len(_HEAT) - 2)
    f = x - i
    rgb = [(1 - f) * a + f * b for a, b in zip(_HEAT[i], _HEAT[i + 1])]
    return "#%02x%02x%02x" % tuple(int(round(255 * c)) for c in rgb)


def _scale_xy(xs, ys, w, h, pad):
    """Shared axis scaling: filter non-finite pairs, map to pixel
    coordinates.  Returns (X, Y, x0, x1, y0, y1) or None if < 2 points."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ok = np.isfinite(xs) & np.isfinite(ys)
    xs, ys = xs[ok], ys[ok]
    if xs.size < 2:
        return None
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    if x1 == x0:
        x1 = x0 + 1.0
    if y1 == y0:
        y1 = y0 + 1.0
    X = pad + (xs - x0) / (x1 - x0) * (w - 2 * pad)
    Y = (h - 14) - (ys - y0) / (y1 - y0) * (h - 14 - pad)
    return X, Y, x0, x1, y0, y1


def _polyline(xs, ys, w=340, h=120, pad=6, stroke=_ACCENT,
              labels=("", ""), dots=False) -> str:
    """Minimal single-series line plot as an SVG string; ``dots`` adds
    per-point markers (same scaling, same finite filtering)."""
    scaled = _scale_xy(xs, ys, w, h, pad)
    if scaled is None:
        return (f'<svg width="{w}" height="{h}"><text x="8" y="20" '
                f'fill="{_MUTED}" font-size="11">no data</text></svg>')
    X, Y, x0, x1, y0, y1 = scaled
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(X, Y))
    marks = "".join(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" '
                    f'fill="{stroke}"/>' for x, y in zip(X, Y)) \
        if dots else ""
    xl, yl = labels
    return (
        f'<svg width="{w}" height="{h}" role="img">'
        f'<line x1="{pad}" y1="{h - 14}" x2="{w - pad}" y2="{h - 14}" '
        f'stroke="{_GRID}"/>'
        f'<polyline points="{pts}" fill="none" stroke="{stroke}" '
        f'stroke-width="2" stroke-linejoin="round"/>{marks}'
        f'<text x="{pad}" y="{h - 2}" fill="{_MUTED}" font-size="10">'
        f'{html.escape(f"{xl}  [{x0:.4g} … {x1:.4g}]")}</text>'
        f'<text x="{w - pad}" y="{h - 2}" fill="{_MUTED}" font-size="10" '
        f'text-anchor="end">{html.escape(f"{yl} [{y0:.4g} … {y1:.4g}]")}'
        f'</text></svg>')


def _dotline(xs, ys, w=300, h=110, pad=8) -> str:
    """Correlator tap shape: markers joined by a thin line (one series)."""
    return _polyline(xs, ys, w, h, pad,
                     labels=("tap offset (samples)", "|corr|"), dots=True)


def _heatmap(P, dopp_hz, w=340, h=150, max_cells=(36, 72),
             scale=1.0, codei=None) -> str:
    """Doppler x code-phase power surface, block-max downsampled to at
    most ``max_cells`` and painted on the sequential ramp."""
    P = np.asarray(P, np.float32)
    F, N = P.shape
    rf = -(-F // max_cells[0])
    rn = -(-N // max_cells[1])
    Fp, Np = -(-F // rf), -(-N // rn)
    Ppad = np.full((Fp * rf, Np * rn), P.min(), P.dtype)
    Ppad[:F, :N] = P
    D = Ppad.reshape(Fp, rf, Np, rn).max(axis=(1, 3))
    lo, hi = float(D.min()), float(D.max())
    rng = (hi - lo) or 1.0
    cw = (w - 8) / Np
    ch = (h - 16) / Fp
    cells = []
    for i in range(Fp):
        y = (h - 16) - (i + 1) * ch          # low Doppler at the bottom
        row = D[i]
        for j in range(Np):
            cells.append(
                f'<rect x="{4 + j * cw:.1f}" y="{y:.1f}" '
                f'width="{cw + 0.5:.1f}" height="{ch + 0.5:.1f}" '
                f'fill="{_heat_color((float(row[j]) - lo) / rng)}"/>')
    marker = ""
    if codei is not None and N:
        # surface spans N cells x `scale` full-rate samples each, drawn
        # across Np*cw pixels; codei is full-rate
        xm = 4 + (codei / (scale * N)) * (Np * cw)
        xm = min(max(xm, 4.0), w - 4.0)
        marker = (f'<line x1="{xm:.1f}" y1="0" x2="{xm:.1f}" '
                  f'y2="{h - 16}" stroke="{_INK}" stroke-width="1" '
                  'stroke-dasharray="3,2"/>')
    d0, d1 = float(dopp_hz[0]), float(dopp_hz[-1])
    return (
        f'<svg width="{w}" height="{h}" role="img">{"".join(cells)}'
        f'{marker}'
        f'<text x="4" y="{h - 4}" fill="{_MUTED}" font-size="10">'
        f'code phase 0…{int(N * scale)} samp</text>'
        f'<text x="{w - 4}" y="{h - 4}" fill="{_MUTED}" font-size="10" '
        f'text-anchor="end">Doppler {d0:+.0f}…{d1:+.0f} Hz</text></svg>')


def render_html(rx, t: float, interval_s: float) -> str:
    """The whole page as a string (pure host-side telemetry)."""
    parts = getattr(rx, "rx", [rx])
    rows = channel_rows(parts)
    locked = sum(r["state"] != "idle" for r in rows)
    dec = sum(r["state"] == "nav" for r in rows)
    hub = getattr(rx, "hub", None)

    trs = []
    for r in rows:
        tow = f"{r['tow']:.1f}" if r["tow"] is not None else "–"
        cn0 = f"{r['cn0']:.1f}" if r["state"] != "idle" else "–"
        dop = f"{r['dopp']:+.1f}" if r["state"] != "idle" else "–"
        pr = (f"{r['prompt']:.0f}" if r["state"] in ("track", "nav")
              else "–")
        bg = _STATE_BG.get(r["state"], "#fff")
        trs.append(
            f'<tr><td>{r["prn"]}</td><td>{html.escape(r["ctype"])}</td>'
            f'<td style="background:{bg}">{html.escape(r["state"])}</td>'
            f'<td class="n">{cn0}</td><td class="n">{dop}</td>'
            f'<td class="n">{pr}</td><td class="n">{tow}</td></tr>')

    figs = []
    # spectrum + histogram from the monitor's latest frame
    for r in parts:
        mon = getattr(r, "spec_monitor", None)
        frame = mon.latest if mon is not None else None   # property
        if frame is not None:
            figs.append(
                '<figure><figcaption>IF spectrum (dB)</figcaption>'
                + _polyline(frame.freq_hz / 1e6, frame.pspec_db,
                            labels=("MHz", "dB")) + "</figure>")
            # hist_edges is already per-bin (sample_histogram returns
            # edges[:-1], same length as counts)
            figs.append(
                '<figure><figcaption>sample histogram</figcaption>'
                + _polyline(frame.hist_edges, frame.hist_counts,
                            labels=("value", "count")) + "</figure>")
            break
    # newest acquisition surface (pltacq)
    newest = None
    for r in parts:
        for prn, v in getattr(r, "acq_views", {}).items():
            if newest is None or v["t"] > newest[1]["t"]:
                newest = (prn, v)
    if newest is not None:
        prn, v = newest
        figs.append(
            f'<figure><figcaption>PRN {prn} acquisition @ '
            f'{v["t"]:.1f} s, C/N0 {v["cn0"]:.1f} dB-Hz</figcaption>'
            + _heatmap(v["surface"], v["dopp_hz"],
                       scale=v.get("grid_scale", 1.0),
                       codei=v.get("codei")) + "</figure>")
    # correlator tap shapes (plttrk), newest few
    cvs = [(prn, cv, r) for r in parts
           for prn, cv in getattr(r, "corr_views", {}).items()]
    cvs.sort(key=lambda x: -x[1]["t"])
    for prn, cv, _ in cvs[:6]:
        figs.append(
            f'<figure><figcaption>PRN {prn} taps @ {cv["t"]:.1f} s'
            '</figcaption>' + _dotline(cv["offsets"], cv["mag"])
            + "</figure>")

    spp = ""
    if hub is not None and getattr(hub, "positions", None):
        import math
        from ..obs.spp import ecef2llh
        wk, tow, pos, clk, nsat = hub.positions[-1]
        lat, lon, hgt = ecef2llh(pos)
        spp = (f'<p class="spp">SPP tow={tow:.1f} '
               f'lat={math.degrees(lat):.6f} lon={math.degrees(lon):.6f} '
               f'h={hgt:.1f} m ({nsat} sats)</p>')

    # rx.events is already time-sorted across front-end groups (both
    # Receiver and the MultiReceiver wrapper expose the sorted property)
    ev_html = "".join(f"<li>{html.escape(' '.join(str(x) for x in e))}"
                      "</li>" for e in rx.events[-6:])

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="{max(interval_s, 0.5):.1f}">
<title>erlang-gnss-tpu live</title>
<style>
 body {{ font: 13px/1.45 system-ui, sans-serif; color: {_INK};
        margin: 16px; background: #fff; }}
 h1 {{ font-size: 16px; margin: 0 0 2px; }}
 .sub {{ color: {_MUTED}; margin: 0 0 10px; }}
 table {{ border-collapse: collapse; margin-right: 18px; }}
 th, td {{ padding: 1px 8px; text-align: left;
           border-bottom: 1px solid {_GRID}; font-size: 12px; }}
 td.n {{ text-align: right; font-variant-numeric: tabular-nums; }}
 th {{ color: {_MUTED}; font-weight: 600; }}
 .wrap {{ display: flex; flex-wrap: wrap; gap: 10px;
          align-items: flex-start; }}
 figure {{ margin: 0; }}
 figcaption {{ color: {_MUTED}; font-size: 11px; margin-bottom: 2px; }}
 ul {{ color: {_MUTED}; font-size: 11px; }}
 .spp {{ font-variant-numeric: tabular-nums; }}
</style></head><body>
<h1>erlang-gnss-tpu</h1>
<p class="sub">t = {t:.1f} s &nbsp; locked {locked}/{len(rows)} &nbsp;
decoded {dec} &nbsp; epochs {rx.epochs_written} &nbsp;
eph {getattr(hub, "ephs_written", 0)}</p>
<div class="wrap">
<table><tr><th>PRN</th><th>SIG</th><th>STATE</th><th>C/N0</th>
<th>DOPPLER</th><th>PROMPT</th><th>TOW</th></tr>{"".join(trs)}</table>
<div class="wrap" style="max-width:740px">{"".join(figs)}</div>
</div>
{spp}
<ul>{ev_html}</ul>
</body></html>
"""


class HtmlView:
    """File-based live view: ``tick(t)`` rewrites ``path`` atomically at
    the SPEC_MS cadence of STREAM time (same throttle as diag.watch)."""

    def __init__(self, rx, path: str,
                 interval_s: float = SPEC_MS / 1000.0):
        self.rx = rx
        self.path = path
        self.interval = float(interval_s)
        self._next_t = 0.0

    def tick(self, t: float) -> None:
        if t < self._next_t:
            return
        self._next_t = t + self.interval
        try:
            text = render_html(self.rx, t, self.interval)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, self.path)  # readers never see a torn page
        except Exception as e:          # diagnostics must never take
            import sys                  # down the receiver run — ANY
            # render failure (unexpected telemetry shape, None field,
            # disk error) is logged and skipped, not propagated through
            # the receiver's progress callback
            print(f"watch-html: {type(e).__name__}: {e}", file=sys.stderr)

    def close(self) -> None:
        try:
            self.tick(self._next_t)    # force one final frame
        except Exception:              # pragma: no cover
            pass
