"""A skewed full-alphabet byte histogram taken from two public
specifications: the column ``L_PARTKEY`` of TPC-H's ``LINEITEM`` at scale
factor 10 (TPC-H 3.0.1, clause 4.2.3: a random value in
[1, SF * 200,000], here [1, 2,000,000]), as Parquet's PLAIN encoding
writes an ``INT32`` column: four bytes a value, little-endian, value after
value.

So the high byte of every value is 0, its third byte is ``key >> 16``
(0 to 30) and its two low bytes are near uniform: byte 0 makes ~26 % of the
document (a code of 2 bits, so up to four symbols end in one body byte,
m = 4), bytes 1 to 30 ~1 % each and every other byte ~0.2 %; all 256
occur, with codes of 2 to 10 bits and a body of ~81 % of the document.

``shape``, the document's generator shared by every seed, draws the
document's keys; ``rng``, the run's generator, draws only their order (the
rows'). So each document has a histogram of its own, while its histogram,
its code lengths and its body's size are the same for every seed: every
seed gives the same work in size and shape, in another order.
"""

from __future__ import annotations

import numpy as np

SCALE_FACTOR = 10
KEYS = 200_000 * SCALE_FACTOR  # L_PARTKEY's range at this scale factor


def make(n_bytes: int, rng: np.random.Generator, shape: np.random.Generator) -> bytes:
    """``n_bytes`` of the column: its keys from ``shape``, their order from
    ``rng``."""
    keys = shape.integers(1, KEYS + 1, size=-(-n_bytes // 4), dtype=np.int32)
    rng.shuffle(keys)
    return keys.astype("<i4").tobytes()[:n_bytes]
