"""The 90th percentile of every request's latency in the window, from
submission to the PIL image (nearest rank)."""

import math


def read(run):
    if not run.latencies:
        return None
    ordered = sorted(run.latencies)
    return ordered[math.ceil(0.9 * len(ordered)) - 1]
