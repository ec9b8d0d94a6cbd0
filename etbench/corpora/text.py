"""English text: the lines of *A Midsummer Night's Dream* (``midsummer.txt``
beside this file, 112,541 B, 3,124 lines, 93 distinct bytes), drawn with
weights of the document's own.

``shape``, the document's generator shared by every seed, draws which lines
the document holds: every line once, so all 93 bytes occur, then lines
drawn with replacement under ``Gamma(1)`` weights until the size is reached,
the last one cut to fit. ``rng``, the run's generator, puts the whole lines
in an order of its own, and the cut line ends the document. So each
document has a byte histogram, and a code table, of its own, as distinct
files of one corpus do, while its histogram, its body's size and its code
lengths are the same for every seed: every seed gives the same work in size
and shape, in another order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

LINES = Path(__file__).with_name("midsummer.txt").read_bytes().splitlines(keepends=True)
LENS = np.array([len(x) for x in LINES], dtype=np.int64)
WEIGHT_SHAPE = 1.0  # the Gamma shape of the line weights


def make(n_bytes: int, rng: np.random.Generator, shape: np.random.Generator) -> bytes:
    """``n_bytes`` of lines: which lines from ``shape``, their order from
    ``rng``."""
    p = shape.gamma(WEIGHT_SHAPE, size=len(LINES))
    p /= p.sum()
    picks = [shape.permutation(len(LINES))]
    total = int(LENS.sum())
    while total < n_bytes:
        more = shape.choice(len(LINES), size=int((n_bytes - total) / float(p @ LENS)) + 64, p=p)
        picks.append(more)
        total += int(LENS[more].sum())
    picks = np.concatenate(picks)
    keep = int(np.searchsorted(np.cumsum(LENS[picks]), n_bytes))  # picks[keep] reaches the size
    whole, last = picks[:keep], int(picks[keep])
    order = rng.permutation(whole)
    head = b"".join([LINES[i] for i in order.tolist()])
    return (head + LINES[last])[:n_bytes]
