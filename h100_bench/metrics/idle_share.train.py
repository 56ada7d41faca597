"""Share of the profiled stretch, from its first host call to its last
synchronize, in which no operation ran on the device."""


def read(run):
    s = run.stretch
    return 100 * (1 - s.busy_s / s.window_s) if s is not None and s.window_s > 0 and s.kernels else None
