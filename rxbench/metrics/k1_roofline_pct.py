"""k1_roofline_pct (ops kernels layer): K1's bound over its device time in
the traced window, in percent.  The bound is the work of the super-steps
the traced blocks ran (``rxbench/peaks.py``: from the problem's shapes,
each steady group's channels, its tracking channels, L periods of nsamp
samples, the taps), the time the sum of the ``band_taps`` kernels in the
trace.  Nothing is read when the trace's K1 launches differ from the
super-steps run.  Moves rx_msps."""
from rxbench import peaks


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["k1_launches"] == 0 or tr["k1_s"] <= 0:
        return None
    jobs = {j["index"]: j for j in ctx["jobs"]}
    launches, bound = 0, 0.0
    for b in ctx["blocks"]:
        if not b["traced"]:
            continue
        job = jobs[b["job"]]
        for g, stage, active in zip(job["groups"], b["stages"], b["locked"]):
            if stage != "steady":
                continue
            n = g["nsteps"] // g["L"]
            launches += n
            nbytes, flops = peaks.k1_work(
                channels=g["channels"], active=active, periods=g["L"],
                nsamp=g["nsamp"], taps=job["taps"], smax=job["smax"],
                iq=job["iq"])
            bound += n * peaks.bound_s(nbytes, flops)
    if abs(launches - tr["k1_launches"]) > 0.01 * launches:
        return None
    # the mean bound per launch over the mean device time per launch
    return 100.0 * (bound / launches) / (tr["k1_s"] / tr["k1_launches"])
