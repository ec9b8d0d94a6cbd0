"""The 95th percentile of the host-clock wall time of every ``decompress``
call of the window, in ms (each call ends in ``bytes`` on the host; a call
that raised counts with its time)."""

import statistics


def read(w):
    ms = [(c.end - c.start) * 1e3 for c in w.calls if c.op == "decompress"]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
