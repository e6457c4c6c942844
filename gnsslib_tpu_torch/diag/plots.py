"""Optional matplotlib renderings of the diagnostics: the port's own copy
of :mod:`gnsslib_tpu.diag.plots`.

The reference pipes live views to gnuplot (src/sdrplot.c: acquisition
surface, correlator shape, spectrum, histogram).  Here the same views
render to PNG files from the data-level outputs; matplotlib is optional —
every function degrades to a no-op returning None without it.
"""
from __future__ import annotations

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:                      # pragma: no cover
        return None


def plot_spectrum(freq, p_db, path: str, title: str = "IF spectrum"):
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(np.asarray(freq) / 1e6, p_db, lw=0.7)
    ax.set_xlabel("frequency (MHz)")
    ax.set_ylabel("power (dB)")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_histogram(edges, counts, path: str, title: str = "IF samples"):
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.bar(np.asarray(edges), counts, width=0.9)
    ax.set_xlabel("sample value")
    ax.set_ylabel("count")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_acq_surface(P, dopp_hz, path: str, title: str = "acquisition",
                     scale: float = 1.0, codei: int | None = None):
    """Doppler x code-phase power surface (reference pltacq view,
    src/sdrmain.c:258-261).  ``scale``: full-rate samples per surface
    code-phase cell (> 1 when the surface came from the coarse search
    grid) so the x axis — and the optional full-rate ``codei`` marker —
    stay in samples."""
    plt = _plt()
    if plt is None:
        return None
    P = np.asarray(P)
    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(P, aspect="auto", origin="lower",
                   extent=[0, P.shape[1] * scale, dopp_hz[0], dopp_hz[-1]])
    if codei is not None:
        ax.axvline(codei, color="w", ls="--", lw=0.8, alpha=0.7)
    ax.set_xlabel("code phase (samples)")
    ax.set_ylabel("Doppler (Hz)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="power")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_correlator(corrx, sum_i, path: str, title: str = "correlator"):
    """E/P/L correlation shape (reference plttrk view,
    src/sdrmain.c:293-299)."""
    plt = _plt()
    if plt is None:
        return None
    order = np.argsort(corrx)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(np.asarray(corrx)[order], np.asarray(sum_i)[order], "o-")
    ax.set_xlabel("tap offset (samples)")
    ax.set_ylabel("coherent I")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
