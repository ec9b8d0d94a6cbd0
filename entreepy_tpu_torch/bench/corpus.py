"""The bench's corpora: the generators of the JAX repo's bench scripts, byte
for byte.

* :func:`make_corpus` — ``benchmarks/scale.py``'s four families (a fresh
  ``default_rng(1234)`` per call): ``text`` (the midsummer fixture tiled),
  ``random`` (uniform bytes), ``skewed`` (Zipf 1.3 over the byte alphabet),
  ``runheavy`` (4096 ``a`` and 256 random bytes, repeated and cut to size);
* :func:`build_corpus` — ``bench.py``'s headline text, the fixture tiled to
  5,200,000 B (also ``_mh_bench_worker.py``'s text at its size);
* :func:`extras` — ``bench.py``'s random and run-heavy extras, one
  ``default_rng(11)`` drawn random first, then run-heavy; the run-heavy one
  is ``n // 4352`` whole units, not cut to ``n``.

The text fixture is ``tests/data/a_midsummer_nights_dream.txt`` of the
checkout this package sits in (``_build.checkout_root``); an installed
package has none, so its caller passes the file (the bench's ``--text``).
This module imports numpy and the standard library only:
``tools/torch_kernel_ab.py`` loads it by its path and always passes the
text file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

TEXT_BYTES = 5_200_000  # bench.py's TARGET_BYTES
KINDS = ("text", "random", "skewed", "runheavy")
FIXTURE = Path("tests") / "data" / "a_midsummer_nights_dream.txt"
RUNHEAVY_UNIT = 4096 + 256


class NoTextError(FileNotFoundError):
    """No text fixture: an installed package outside a checkout."""


def text_path(text: str | Path | None = None) -> Path:
    """``text`` when given, else the checkout's fixture; outside a checkout
    (an installed package) that is an error naming ``--text``."""
    if text is not None:
        return Path(text)
    from .._build import checkout_root

    root = checkout_root()
    if root is None:
        raise NoTextError(
            f"no checkout around this package, so no {FIXTURE}: pass the text "
            "corpus file with --text PATH")
    return root / FIXTURE


def _tiled(src: bytes, n: int) -> bytes:
    return (src * (-(-n // len(src))))[:n]


def make_corpus(kind: str, n: int, text: str | Path | None = None) -> bytes:
    """``n`` bytes of the family ``kind`` (benchmarks/scale.py:33-49)."""
    rng = np.random.default_rng(1234)
    if kind == "text":
        return _tiled(text_path(text).read_bytes(), n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "skewed":
        p = 1.0 / np.arange(1, 257) ** 1.3
        p /= p.sum()
        return rng.choice(256, size=n, p=p).astype(np.uint8).tobytes()
    if kind == "runheavy":
        unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        return _tiled(unit, n)
    raise ValueError(f"unknown corpus kind {kind!r} (want one of {KINDS})")


def build_corpus(n: int = TEXT_BYTES, text: str | Path | None = None) -> bytes:
    """The headline text: the fixture tiled to ``n`` bytes (bench.py:47-50)."""
    return make_corpus("text", n, text)


def extras(n: int) -> list[tuple[str, bytes]]:
    """bench.py's extras beside an ``n``-byte headline (bench.py:408-413):
    [("random", n uniform bytes), ("runheavy", n // 4352 whole units)]."""
    rng = np.random.default_rng(11)
    random = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    return [("random", random), ("runheavy", unit * (n // RUNHEAVY_UNIT))]
