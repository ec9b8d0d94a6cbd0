"""The decode kernels' share of the memory roofline, %: the ``.et`` bodies
read once and the decoded bytes written once, counted from the workload,
at the card's published rate, over the summed device time of every CUDA
kernel of the window's calls (profiler)."""

from etbench.reduce import roofline_pct


def read(r):
    return roofline_pct(r, r.work["body_bytes"] + r.work["orig_bytes"])
