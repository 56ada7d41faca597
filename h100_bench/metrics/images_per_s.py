"""Images completed over the window's whole time: from its start to the
end of its last request."""


def read(run):
    return run.items / run.window_s if run.window_s > 0 else None
