"""Host milliseconds inside `fluxion.graphs.Program.__call__` (key walk,
static copies, graph launch, output clones) per request or step, over the
traced run's unprofiled window."""


def read(run):
    return 1e3 * run.program_host_s / run.calls if run.calls else None
