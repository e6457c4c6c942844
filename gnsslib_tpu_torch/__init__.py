"""gnsslib_tpu_torch — the GNSS SDR receiver on PyTorch and CUDA.

A port of :mod:`gnsslib_tpu` (JAX/Pallas) to PyTorch with a hand-written
CUDA band correlator for NVIDIA Hopper.  The module layout follows the JAX
package so each counterpart is easy to find:

* ``ops``      — NCO tables, carrier mixing, code resampling, tap
                 correlation, FFT correlation, masked reductions, and the
                 band correlator (``ops.band_taps``, kernel in
                 ``csrc/band_taps.cu``).
* ``track``    — per-period ``Tracker`` (pull-in) and the steady-state
                 ``FastTracker`` (L periods per super-step).
* ``acquire``  — batched FFT acquisition search.
* ``io``       — the device-resident sample cache.
* ``runtime``  — configuration, the file-replay ``Receiver`` and the CLI.

Host-side layers without any array framework (codes, nav decoding,
observables, RINEX writers, front-end file formats) are imported from
:mod:`gnsslib_tpu`, so there is one copy of each byte-exact writer.

This package imports ``torch`` and never ``jax``.  Every function takes
an explicit ``device``; there is no global default device and no silent
fallback from CUDA to the CPU.
"""

__version__ = "0.1.0"
