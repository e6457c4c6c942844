"""acquire_s: mean per job of the receiver's ``stage_wall["acquire"]``, the
wall seconds its ``step_block`` spends in that stage, summed over the
channel groups.  Moves rx_msps."""
from rxbench.metrics._common import stage_mean


def read(ctx):
    return stage_mean(ctx["jobs"], "acquire")
