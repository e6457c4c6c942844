"""Diagnostics: spectrum analyzer, histogram, live monitor, tracking logs.

Reference: src/sdrspec.c (live IF spectrum + sample histogram) and the
per-channel CSV tracking logs (src/sdrout.c:386-457).  Rendering is
data-first: spectra/histograms are returned as arrays (plot with any
tool, or the optional ``plots``); CSV logs match the reference column
layout.  The operator views (``watch``, ``htmlview``) read host-side
telemetry only.
"""
from .monitor import SpecFrame, SpectrumMonitor
from .spectrum import sample_histogram, welch_spectrum
from .tracklog import TrackLogger

__all__ = ["sample_histogram", "welch_spectrum", "TrackLogger",
           "SpecFrame", "SpectrumMonitor"]
