"""The most device memory the process held in the window
(`torch.cuda.max_memory_reserved` after `reset_peak_memory_stats` at its
start): tensors, the allocator's cached blocks and the graphs' pools."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
