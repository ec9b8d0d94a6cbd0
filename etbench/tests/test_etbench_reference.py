"""The benchmark's plain reference and its data, on the CPU.

Run from the root of a checkout: ``python -m pytest etbench/tests -q``.
The reference imports nothing of the program; these tests are the one place
where the two meet (the port's host codec, the framework-free original).
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest

from etbench import reference
from etbench.cells import load_cell
from etbench.reference import control, pack
from etbench.reference.etformat import parse_table
from etbench.traffic import documents

REF_DIR = Path(reference.__file__).parent


def _text(n: int, seed: int) -> bytes:
    cell = load_cell("text-5.2MB.decode")
    cell.config["doc_bytes"] = n
    return documents(cell, seed)[0]


def _family(kind: str, n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "text":
        return _text(n, seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "skewed":
        p = 1.0 / np.arange(1, 257) ** 1.3
        return rng.choice(256, size=n, p=p / p.sum()).astype(np.uint8).tobytes()
    unit = b"a" * 4096 + rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
    return (unit * (n // len(unit) + 1))[:n]


@pytest.mark.parametrize("kind", ["text", "random", "skewed", "runheavy"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_reference_writes_the_port_host_codecs_file(kind, seed):
    from entreepy_tpu_torch.format import compress_host

    doc = _family(kind, 150_000, seed)
    assert reference.et_file(doc) == compress_host(doc)


def test_reference_across_pack_slices(monkeypatch):
    from entreepy_tpu_torch.format import compress_host

    doc = _text(70_001, 3)
    monkeypatch.setattr(pack, "SLICE", 997)  # many slices, boundaries inside words
    assert reference.et_file(doc) == compress_host(doc)


@pytest.mark.parametrize("name", ["nice.shakespeare", "a_midsummer_nights_dream", "test"])
def test_reference_known_answer(name):
    """Byte for byte the files the upstream tool wrote (the repo's golden
    files), so the reference is anchored to upstream, not to the port."""
    data = Path(__file__).resolve().parents[2] / "tests" / "data"
    golden = (data / f"{name}.et").read_bytes()
    assert reference.et_file((data / f"{name}.txt").read_bytes()) == golden
    if name == "nice.shakespeare":
        assert len(golden) == 374


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("entreepy_tpu_torch", "entreepy_tpu", "jax", "torch"), \
                    (path.name, n)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40])
def test_documents_are_a_function_of_the_seed(seed):
    cell = load_cell("text-5.2MB.decode")
    cell.config["doc_bytes"] = 200_000
    a, b = documents(cell, seed), documents(cell, seed)
    assert a == b and len(a) == cell.mix["documents"] == 4
    assert all(len(d) == 200_000 for d in a)
    assert len(set(a)) == 4  # every document of the pool differs
    assert documents(cell, seed + 1) != a


def test_text_keeps_the_plays_bytes():
    doc = _text(500_000, 9)
    play = (Path(control.__file__).parents[1] / "corpora" / "midsummer.txt").read_bytes()
    assert set(doc) == set(play)
    assert doc != (play * 5)[:500_000]


def _table(doc: bytes):
    t = parse_table(reference.et_file(doc))[0]
    return t.codes.tobytes() + t.lengths.tobytes(), t.lengths


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_every_document_has_a_code_table_of_its_own(seed):
    """Each document of a pool its own table; each seed the same tables, so
    the same work, from other orders of the lines."""
    cell = load_cell("text-5.2MB.decode")
    cell.config["doc_bytes"] = 1_000_000
    docs, again = documents(cell, seed), documents(cell, seed + 1)
    tables = [_table(d) for d in docs]
    assert len({t for t, _ in tables}) == len(docs) == 4
    assert [_table(d)[0] for d in again] == [t for t, _ in tables]
    assert all(a != b for a, b in zip(docs, again))
    assert all(int(n[n > 0].min()) == 3 and int(n.max()) <= 32 for _, n in tables)


@pytest.mark.parametrize("name", ["text-5.2MB.decode", "text-100MB.decode"])
def test_every_call_has_labels_of_its_own(name):
    from etbench.traffic import Feed

    cell = load_cell(name)
    cell.config["doc_bytes"] = 40_000
    feed = Feed(cell, 2**33 + 1)
    assert feed.relabel
    heads, bodies = set(), set()
    for i in range(12):
        key, et = feed.call(i)
        table, n, start = parse_table(et)
        base = parse_table(feed.ets[key[0]])
        assert start == base[2] and n == base[1] and et[start:] == feed.ets[key[0]][start:]
        assert sorted(table.lengths) == sorted(base[0].lengths)
        heads.add(et[:start])
        bodies.add(et[start:])
        # the whole body decoded by the reference's automaton in one chunk
        assert control.nosync_decode(et, chunk_bytes=len(et) - start) == feed[key]
        got, doc = (np.bincount(np.frombuffer(x, np.uint8), minlength=256)
                    for x in (feed[key], feed.docs[key[0]]))
        assert set(np.flatnonzero(got)) == set(np.flatnonzero(doc))
        assert sorted(got) == sorted(doc)  # the document's bytes, relabelled
    assert len(heads) == 12 and len(bodies) == len(feed.docs)


def test_one_chunk_fsm_decode_is_exact():
    doc = _text(60_000, 4)
    et = reference.et_file(doc)
    start = parse_table(et)[2]
    assert control.nosync_decode(et, chunk_bytes=len(et) - start) == doc


def test_controls_differ_from_the_reference():
    doc = _text(60_000, 5)
    et = reference.et_file(doc)
    assert control.nosync_decode(et) != doc
    canon = reference.et_file(doc, canonical=True)
    assert len(canon) == len(et) and canon != et


def test_canonical_table_is_prefix_free():
    table = parse_table(reference.et_file(_text(30_000, 6)))[0]
    canon = control.canonical_table(table)
    codes = {format(int(canon.codes[s]), f"0{int(n)}b") for s, n in enumerate(canon.lengths) if n}
    assert not any(a != b and b.startswith(a) for a in codes for b in codes)
