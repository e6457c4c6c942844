"""build_s (runtime layer): mean per job of the seconds each channel group
spends in its ``precompiled`` milestone (``timeline["precompiled"]``: the
block programs' warm-up and CUDA graph captures, the kernels' load), summed
over the groups.  Moves rx_msps."""
from rxbench.metrics._common import untraced


def read(ctx):
    js = untraced(ctx["jobs"])
    if not js:
        return None
    return sum(sum(g["precompiled"] for g in j["groups"])
               for j in js) / len(js)
