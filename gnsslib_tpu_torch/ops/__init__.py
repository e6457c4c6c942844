"""DSP library of the port (counterpart of :mod:`gnsslib_tpu.ops`).

Plain functions on torch tensors.  The one hand-written kernel is the
steady-state band correlator, :func:`band_taps.band_taps` (CUDA C++ in
``csrc/band_taps.cu``), with its plain PyTorch version beside it.
"""
from .nco import CarrierTables, CodeTables  # noqa: F401
from .carrier import mix_carrier  # noqa: F401
from .resample import resample_code  # noqa: F401
from .correlator import correlate_taps, tap_offsets  # noqa: F401
from .fftcorr import fft_correlate_power  # noqa: F401
from .stats import masked_max, masked_mean, lagrange_interp  # noqa: F401
