"""The most memory the allocator held on the card during the traced
steps (``torch.cuda.max_memory_allocated``), in GiB: what the offload of
the layers' inputs leaves room for."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
