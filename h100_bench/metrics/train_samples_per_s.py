"""Samples trained over the window's whole time, optimizer steps included:
from its start to the end of its last step."""


def read(run):
    return run.items / run.window_s if run.window_s > 0 else None
