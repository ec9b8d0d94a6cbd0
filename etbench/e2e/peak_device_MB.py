"""The most device memory allocated (``torch.cuda.max_memory_allocated``)
on any card the cell uses, over the whole run, in 10^6 B."""


def read(w):
    return None if w.peak_bytes is None else w.peak_bytes / 1e6
