"""Observable formation and output: history, epoch alignment, RINEX/RTCM.

Host-side subsystem (reference: src/sdrsync.c + src/sdrout.c + the
setobsdata part of src/sdrtrk.c:160-208).  All inputs arrive as batched
arrays from the device tracker; everything here is NumPy/pure Python.
"""
from .history import ObsHistory
from .epoch import EpochAligner, SdrObs, interp1
from .rinex import RinexObsWriter, RinexNavWriter

__all__ = ["ObsHistory", "EpochAligner", "SdrObs", "interp1",
           "RinexObsWriter", "RinexNavWriter"]
