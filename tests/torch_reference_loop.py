"""The port's carrier loop as the reference (sdrtrk.c) and the JAX package
run it, for the test modules that hold the port's tracking against the
JAX package's.  The port lets a channel's FLL pull in alone for its first
``FLL_PULLIN`` code periods (``gnsslib_tpu_torch/track/loop.py``); the
fixture puts the PLL back on from a channel's start, so every other output
is held as before.  The port's own loop is held by
tests/test_torch_sbas_pullin.py.

A module uses it with::

    from torch_reference_loop import reference_carrier_loop  # noqa: F401
    pytestmark = pytest.mark.usefixtures("reference_carrier_loop")
"""
import pytest


@pytest.fixture(scope="module")
def reference_carrier_loop():
    from gnsslib_tpu_torch.track import loop
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "FLL_PULLIN", 0)
    yield
    mp.undo()
