"""What each call of a run is given, and what it must give back.

A cell's pool holds ``documents`` documents of its configuration, the i-th
made by the corpus family from the generator of (seed, i) and from one of
its own, the same for every seed (:func:`documents`); a ``decompress``
mix gives the program each document's ``.et`` file as the plain reference
writes it. The window cycles through the pool.

With ``"relabel": true`` in a ``decompress`` mix, call ``i`` is given the
``.et`` of its document with the bytes of the dictionary permuted among the
document's own present bytes by the generator of (seed, document, i): the
same body and code lengths, so the same work, under a code table that no
earlier call had, as a reader of distinct files meets. The call must then
return the document with that permutation applied to every byte. Building
such a file takes a new header of at most 1.5 KB and one copy of the body,
outside the call's own span and inside the window.
"""

from __future__ import annotations

import numpy as np

from .reference import et_file
from .reference.etformat import parse_table, serialize_header
from .reference.huffman import CodeTable

SHAPE_KEY = 0x5E7_5A3E  # keys the documents' own generators apart from the runs'


def documents(cell, seed: int) -> list[bytes]:
    """The cell's pool: ``documents`` of ``doc_bytes`` each. The corpus
    family makes the i-th from two generators: that of (seed, i), and the
    document's own, of i alone, for what every seed shares (its histogram,
    so its sizes and code lengths)."""
    corpus = cell.corpus()
    n = int(cell.config["doc_bytes"])
    return [corpus.make(n, np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), i])),
                        np.random.default_rng(np.random.SeedSequence([SHAPE_KEY, i])))
            for i in range(int(cell.mix.get("documents", 1)))]


class Feed:
    """The inputs of one run of ``cell`` on ``seed``, and the reference
    output of each call (``feed[key]``, ``key`` as :meth:`call` gives it)."""

    def __init__(self, cell, seed: int, docs: list[bytes] | None = None):
        self.op, self.seed = cell.op, seed
        self.docs = documents(cell, seed) if docs is None else docs
        self.ets = [et_file(d) for d in self.docs] if self.op == "decompress" else None
        self.relabel = self.op == "decompress" and bool(cell.mix.get("relabel", False))
        self.parsed = [parse_table(e) for e in self.ets] if self.relabel else None
        self._written: dict = {}

    def warm(self) -> list[bytes]:
        """One input per document, as the reference writer made it."""
        return self.ets if self.op == "decompress" else self.docs

    def call(self, i: int) -> tuple[tuple, bytes]:
        """(key, input) of the window's call ``i``."""
        k = i % len(self.docs)
        if self.relabel:
            return (k, i), self.relabelled(k, i)
        return (k, None), (self.ets if self.op == "decompress" else self.docs)[k]

    def permutation(self, k: int, i: int) -> np.ndarray:
        """uint8[256]: byte -> its label in call ``i`` of document ``k``."""
        lengths = self.parsed[k][0].lengths
        present = np.flatnonzero(lengths)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % (1 << 64), k, i, 1]))
        lut = np.arange(256, dtype=np.uint8)
        lut[present] = present[rng.permutation(present.size)]
        return lut

    def relabelled(self, k: int, i: int) -> bytes:
        table, n_orig, start = self.parsed[k]
        lut = self.permutation(k, i)
        present = np.flatnonzero(table.lengths)
        codes = np.zeros_like(table.codes)
        lengths = np.zeros_like(table.lengths)
        codes[lut[present]] = table.codes[present]
        lengths[lut[present]] = table.lengths[present]
        head = serialize_header(CodeTable(codes, lengths), n_orig)
        assert len(head) == start  # the same code lengths: the same header size
        return head + memoryview(self.ets[k])[start:]

    def body_bytes(self, k: int) -> int:
        """The packed body's bytes of document ``k``'s ``.et``."""
        et = self.ets[k] if self.ets is not None else self[(k, None)]
        return len(et) - parse_table(et)[2]

    def __getitem__(self, key: tuple) -> bytes:
        """The output the call ``key`` must return."""
        k, i = key
        if self.op == "compress":
            if k not in self._written:
                self._written[k] = et_file(self.docs[k])
            return self._written[k]
        if i is None or not self.relabel:
            return self.docs[k]
        return self.permutation(k, i)[np.frombuffer(self.docs[k], dtype=np.uint8)].tobytes()
