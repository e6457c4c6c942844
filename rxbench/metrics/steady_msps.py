"""steady_msps (track steady layer): IF samples of the blocks every channel
group ran on its steady-state program, over the host wall time of those
blocks' ``step_block`` calls, over the whole window outside the traced
blocks (all work over all time).  Moves rx_msps."""


def read(ctx):
    bl = [b for b in ctx["blocks"] if not b["traced"]
          and all(s == "steady" for s in b["stages"])]
    wall = sum(b["t1"] - b["t0"] for b in bl)
    if not bl or wall <= 0:
        return None
    return sum(b["samples"] for b in bl) / wall / 1e6
