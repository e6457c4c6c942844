"""Closed-loop code/carrier tracking (port of :mod:`gnsslib_tpu.track`).

``Tracker`` advances every channel one code period at a time (pull-in);
``FastTracker`` runs L periods per super-step once all channels are
bit-synced, through the correlator backend its ``corr`` names.  Both run
a block as one ``program.BlockProgram`` (a CUDA graph on a card).
"""
from .state import (LoopParams, TrackConfig, TrackState,  # noqa: F401
                    state_from_numpy, state_to_numpy)
from .loop import Tracker, TrackOutputs  # noqa: F401
from .fast import FastTracker  # noqa: F401
