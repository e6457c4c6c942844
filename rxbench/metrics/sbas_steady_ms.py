"""sbas_steady_ms (track steady layer, the SBAS group): the host wall of
the SBAS group's ``step_block`` per steady block, in ms: the ``steady``
stage of its ``stage_wall`` (the totals of its span table's
``step_block`` in that stage) over the blocks in which that group ran its
steady program, for the window's untraced jobs.  The SBAS group is the
one whose loop runs every 2 code periods (``L`` 2: 200 super-steps a
block).  None without such a group or without its steady blocks.  Moves
rx_msps."""
from rxbench.metrics._common import untraced

SBAS_L = 2


def read(ctx):
    wall, nblocks = 0.0, 0
    for job in untraced(ctx["jobs"]):
        for i, g in enumerate(job["groups"]):
            if g["L"] != SBAS_L:
                continue
            wall += g["stage_wall"]["steady"]
            nblocks += sum(1 for b in ctx["blocks"]
                           if b["job"] == job["index"]
                           and b["stages"][i] == "steady")
    if nblocks == 0:
        return None
    return 1e3 * wall / nblocks
