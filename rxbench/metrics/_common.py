"""Helpers the per-layer readers share (not a metric: no ``read``)."""
from __future__ import annotations


def untraced(jobs: list) -> list:
    """The window's jobs that ran whole outside the traced window and
    raised nothing; all error-free jobs when no such job exists."""
    ok = [j for j in jobs if j["error"] is None and "groups" in j]
    clean = [j for j in ok if not j["traced"] and j["completed"]]
    return clean or [j for j in ok if not j["traced"]] or ok


def stage_mean(jobs: list, stage: str):
    """Mean per job of the receiver's ``stage_wall[stage]`` summed over
    its channel groups, or None without jobs."""
    js = untraced(jobs)
    if not js:
        return None
    return sum(sum(g["stage_wall"][stage] for g in j["groups"])
               for j in js) / len(js)


def idle_pct(trace):
    """The traced window's share with no kernel, copy or set on the card."""
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
