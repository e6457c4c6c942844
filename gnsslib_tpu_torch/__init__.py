"""gnsslib_tpu_torch — the GNSS SDR receiver on PyTorch and CUDA.

A port of :mod:`gnsslib_tpu` (JAX/Pallas) to PyTorch with hand-written
CUDA correlators for NVIDIA Hopper.  The module layout follows the JAX
package so each counterpart is easy to find:

* ``ops``      — NCO tables, carrier mixing, code resampling, tap
                 correlation, FFT correlation, masked reductions, and the
                 steady-state correlators with their CUDA kernels
                 (``ops.band_taps``, ``ops.window_taps``,
                 ``ops.gram_taps``; sources in ``csrc/``).
* ``track``    — per-period ``Tracker`` (pull-in) and the steady-state
                 ``FastTracker`` (L periods per super-step, correlator
                 backend chosen by ``FastTracker.corr``); each block runs
                 as one ``track.program.BlockProgram``, a CUDA graph
                 replayed per block on a card.
* ``acquire``  — batched FFT acquisition search.
* ``io``       — the file front end and the device-resident sample cache.
* ``runtime``  — configuration, the file-replay ``Receiver`` and the CLI.
* ``spans``    — the receiver's host spans per stage and the device times
                 of its block programs and searches by CUDA events
                 (``Receiver.spans``).
* ``tools``    — ``tools.profile_fast``, the correlator backend profiler.

The host-side layers without any array framework are the port's own
copies of the JAX package's modules, with the same behaviour:
``constants``, ``gtime``, ``sat``, ``codes``, ``nav``, ``obs`` (epoch
alignment, observable history, RINEX writers, satellite positions),
``io.frontend``/``io.formats`` and ``sim`` (signal synthesis).  A test
holds each against its original on the same inputs.

This package imports ``torch`` and never ``jax`` or :mod:`gnsslib_tpu`.
Every function takes an explicit ``device``; there is no global default
device and no silent fallback from CUDA to the CPU.
"""

__version__ = "0.1.0"
