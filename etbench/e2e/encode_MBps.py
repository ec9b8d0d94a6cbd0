"""Original bytes of every ``compress`` that finished in the window, over
the time from the window's start to the end of its last call, in 10^6 B/s."""


def read(w):
    done = [c for c in w.calls if c.op == "compress" and c.ok]
    if not done:
        return None
    return sum(c.orig_bytes for c in done) / (w.calls[-1].end - w.start) / 1e6
