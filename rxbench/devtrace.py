"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
readers and the result's ``breakdown`` need: the device's busy time (the
union of kernel, copy and set intervals) inside the traced window, the
device time by operation name, the K1 launches, and the idle gaps with
the host span (a ``rxbench.*`` annotation the harness records around its
calls into the receiver) that was open in the middle of each."""
from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "rxbench."
WINDOW = SPAN_PREFIX + "window"


def _union(iv: list) -> list:
    """Merged, sorted intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: str, top: int = 10, rename=None) -> dict | None:
    """The summary of the chrome trace at ``path``, or None when it has no
    window annotation or no device activity in it.  Times in seconds;
    ``rename`` maps a span's name (without the prefix) to the name the
    summary gives it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ops, k1 = [], {}, []
    spans = []
    for e in events:
        if "ts" not in e or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            if b <= w0 or a >= w1:
                continue
            a, b = max(a, w0), min(b, w1)
            dev.append((a, b))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a)
            if e.get("cat") == "kernel" and "band_taps" in e["name"]:
                k1.append(b - a)
        elif str(e.get("name", "")).startswith(SPAN_PREFIX) and \
                e["name"] != WINDOW:
            name = e["name"][len(SPAN_PREFIX):]
            spans.append((a, b, rename(name) if rename else name))
    if not dev:
        return None
    merged = _union(dev)
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    # the harness's spans follow one another (none nests in another)
    spans.sort()
    starts = [s[0] for s in spans]

    def host(mid):
        i = bisect.bisect_right(starts, mid) - 1
        return spans[i][2] if i >= 0 and mid < spans[i][1] else "other"
    named = sorted(((host((a + b) / 2), (b - a) * 1e-6) for a, b in gaps),
                   key=lambda g: -g[1])
    idle_by = {}
    for name, s in named:
        idle_by[name] = idle_by.get(name, 0.0) + s
    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        device_ops=[[n, t * 1e-6] for n, t in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, s] for n, s in named[:top]],
        idle_by_span=idle_by,
        k1_launches=len(k1), k1_s=sum(k1) * 1e-6,
        kernels=sum(1 for e in events if e.get("cat") == "kernel"))
