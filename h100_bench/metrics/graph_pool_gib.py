"""Device memory held by the pools of the programs the run called
(`Pool.bytes`), after the window."""


def read(run):
    return run.pool_bytes / 2**30 if run.pool_bytes else None
