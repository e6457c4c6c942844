"""FFT-parallel acquisition (port of :mod:`gnsslib_tpu.acquire`)."""
from .search import Acquirer, AcqResult  # noqa: F401
