"""DSP library of the port (counterpart of :mod:`gnsslib_tpu.ops`).

Plain functions on torch tensors, and the steady-state correlators
written by hand in CUDA C++ (``csrc/``), each with its plain PyTorch
version beside it:

* :func:`band_taps.band_taps` — windows read straight from the block
  (kernel K1, ``csrc/band_taps.cu``);
* :mod:`window_taps` — windows fetched beforehand, direct phase
  (K3 ``correlate_windows16``, K4 ``correlate_windows8``, K5
  ``correlate_windows``; ``csrc/window_taps.cu``);
* :func:`gram_taps.gram_taps` — fetched window rows, factored carrier
  (K2, ``csrc/gram_taps.cu``).
"""
from .nco import CarrierTables, CodeTables  # noqa: F401
from .carrier import mix_carrier  # noqa: F401
from .resample import resample_code  # noqa: F401
from .correlator import correlate_taps, tap_offsets  # noqa: F401
from .fftcorr import fft_correlate_power  # noqa: F401
from .stats import masked_max, masked_mean, lagrange_interp  # noqa: F401
