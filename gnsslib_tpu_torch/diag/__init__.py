"""Diagnostics: per-channel tracking logs.

Reference: the per-channel CSV tracking logs (src/sdrout.c:386-457).  The
JAX package's spectrum analyzer and live monitor are not ported yet.
"""
from .tracklog import TrackLogger

__all__ = ["TrackLogger"]
