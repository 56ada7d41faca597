"""Summed device time of every operation in the profiled stretch, per
image or sample completed in it."""


def read(run):
    s = run.stretch
    return 1e3 * s.device_s / s.items if s is not None and s.items and s.kernels else None
