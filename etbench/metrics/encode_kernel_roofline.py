"""The encode kernels' share of the memory roofline, %: the documents read
once and the ``.et`` bodies written once, counted from the workload, at the
card's published rate, over the summed device time of every CUDA kernel of
the window's calls (profiler)."""

from etbench.reduce import roofline_pct


def read(r):
    return roofline_pct(r, r.work["orig_bytes"] + r.work["body_bytes"])
