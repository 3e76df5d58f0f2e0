"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window (reset at
its start), resident rows included, in GiB."""


def read(w):
    return None if w.peak_bytes is None else w.peak_bytes / 2**30
