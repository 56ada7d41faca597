"""Seconds from the process's start to the window's: imports, the model
built and its weights drawn on the card, adapters attached, the cell's
programs captured and replayed once (and, in a checkout's first run, the
kernels built)."""


def read(run):
    return run.setup_s
