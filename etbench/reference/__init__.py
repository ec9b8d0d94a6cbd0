"""The benchmark's plain reference of the ``.et`` codec, in NumPy.

A frozen copy of the framework-free writer the port carries
(``format/huffman.py``'s table builder, ``format/etformat.py``'s header
writer, ``hostcodec.pack_body_np``'s pack), with the pack's scatter-add
replaced by a chunked ``np.bincount``, which writes the same bytes in a
fraction of the time. It imports nothing of the program, so a later change
to the program cannot move the yardstick.

* :func:`et_file` — a document -> its complete ``.et`` file, byte for byte
  what the upstream ``entreepy`` tool writes;
* ``control`` — the controls that the comparison must fail (canonical
  codes; a chunk-parallel decode without self-synchronisation).
"""

from __future__ import annotations

import numpy as np

from .etformat import serialize_header
from .huffman import build_code_table
from .pack import pack_body, slice_counts


def et_file(doc: bytes, canonical: bool = False) -> bytes:
    """The complete ``.et`` file of ``doc``: header, dictionary, body.
    ``canonical``: with canonical codes instead (``control``)."""
    from .control import canonical_table

    arr = np.frombuffer(doc, dtype=np.uint8)
    counts = slice_counts(arr)
    table = build_code_table(counts.sum(axis=0))
    if canonical:
        table = canonical_table(table)
    return serialize_header(table, arr.size) + pack_body(arr, table, counts)


__all__ = ["et_file"]
