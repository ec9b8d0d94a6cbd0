"""The ``skewed`` family (``corpora/skewed.py``: TPC-H's L_PARTKEY as an
INT32 column) and the cells added with it, ``skewed-100MB.decode`` and
``text-5.2MB.encode``, on the CPU: the documents as a function of the
seed, what every seed shares, the table's m, and the cells as the harness
loads them (``test_etbench_harness.py`` runs every cell through the port's
plain versions).

Run from the root of a checkout: ``python -m pytest etbench/tests -q``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from etbench.cells import ROOT, load_cell
from etbench.reference.huffman import build_code_table
from etbench.traffic import documents

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DECODE, ENCODE = "skewed-100MB.decode", "text-5.2MB.encode"
SMALL = 10**6


def _cell(n: int = SMALL):
    cell = load_cell(DECODE)
    cell.config["doc_bytes"] = n
    return cell


def _doc(seed: int, n: int = SMALL) -> np.ndarray:
    return np.frombuffer(documents(_cell(n), seed)[0], dtype=np.uint8)


def test_documents_are_a_function_of_the_seed():
    a, b = _doc(2**31 + 5), _doc(2**31 + 6)
    assert np.array_equal(a, _doc(2**31 + 5)) and not np.array_equal(a, b)
    assert a.size == b.size == SMALL


def test_every_seed_shares_histogram_lengths_and_body():
    hists = [np.bincount(_doc(s), minlength=256) for s in (1, 2**31 + 7, 2**40 + 3)]
    assert all(np.array_equal(hists[0], h) for h in hists[1:])
    table = build_code_table(hists[0])
    bits = int((hists[0] * table.lengths.astype(np.int64)).sum())
    assert 0.78 * SMALL < bits / 8 < 0.84 * SMALL  # ~81 % of the document
    # all 256 bytes occur, codes of 2 to 10 bits, the 2-bit one byte 0 (every key's high byte)
    assert (hists[0] > 0).all() and table.lengths.min() == 2 and table.lengths.max() == 10
    assert int(np.argmin(table.lengths)) == 0 and 0.25 < hists[0][0] / SMALL < 0.27


def test_the_document_is_a_column_of_keys():
    """Little-endian INT32 values in L_PARTKEY's range at scale factor 10."""
    keys = _doc(2**31 + 5).view("<i4")
    assert keys.min() >= 1 and keys.max() <= 2_000_000 and keys.max() > 1_990_000
    assert np.unique(keys >> 16).size == 31  # the third byte: 0 to 30


def test_documents_differ_in_their_byte_ranks():
    """A document of another index draws other keys: the bytes rank
    otherwise by their counts."""
    cell = _cell()
    cell.mix = {**cell.mix, "documents": 2}
    d0, d1 = (np.bincount(np.frombuffer(d, np.uint8), minlength=256)
              for d in documents(cell, 9))
    assert not np.array_equal(np.argsort(d0, kind="stable"), np.argsort(d1, kind="stable"))


def test_the_table_takes_the_plane_route():
    from entreepy_tpu_torch.format.fsm8 import build_byte_fsm
    from entreepy_tpu_torch.format.huffman import build_code_table as port_table
    from entreepy_tpu_torch.tables import decode_tables

    tables = decode_tables(build_byte_fsm(port_table(np.bincount(_doc(3), minlength=256))), "cpu")
    assert tables.m == 4  # above 3: the one-pass route's plane branch


@pytest.mark.parametrize("name", [DECODE, ENCODE])
def test_the_new_cells_load(name):
    """Each new cell on one card, with at least the metrics it was added with."""
    cell = load_cell(name)
    assert cell.chips == 1 and cell.config["cards"] == 1 and cell.config["backend"] == "device"
    e2e = {m["name"] for m in cell.end_to_end}
    layer = {m["name"] for m in cell.per_layer}
    if name == DECODE:
        assert cell.config["corpus"] == "skewed" and cell.config["doc_bytes"] == 10**8
        assert cell.mix == load_cell("text-100MB.decode").mix  # one document, relabelled
        assert e2e >= {"decode_MBps", "peak_device_MB", "setup_s"}
        assert layer >= {"decode_host_ms", "decode_tables_ms", "decode_transfer_ms",
                         "decode_kernel_roofline", "device_idle.decode", "decode_plane_ms"}
    else:
        assert cell.op == "compress" and cell.mix["documents"] == 4
        assert cell.config["name"] == "text-5.2MB"
        assert e2e >= {"encode_MBps", "peak_device_MB", "setup_s"}
        assert layer >= {"encode_transfer_ms", "encode_host_ms", "encode_kernel_roofline",
                         "device_idle.encode"}


def test_one_four_chip_cell_of_six():
    """The new cells take one chip each, within the harness's rule of at most
    ``max(1, cells // 4)`` four-chip cells; the configuration lists its one
    cut of scale, the rows, in its file and in the benchmark alike."""
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert chips.count(4) <= max(1, len(chips) // 4)
    assert {w["name"]: w["chips"] for w in BENCH["workloads"]}.items() >= {DECODE: 1, ENCODE: 1}.items()
    conf = next(c for c in BENCH["configs"] if c["name"] == "skewed-100MB")
    body = json.loads((ROOT / conf["file"]).read_text())
    assert conf["reduced"] == body["reduced"] == ["rows"]
    assert body["rows"] * 4 == body["doc_bytes"]


def test_decode_plane_ms_reads_the_stage():
    from etbench import reduce
    from etbench.cells import reader

    read = reader("metrics", "decode_plane_ms")
    r = reduce.Reading(op="decompress", calls=4, stages={"plane_compact": 30.0, "device_expand": 50.0},
                       work={}, devices=[0])
    assert read(r) == pytest.approx(7.5)
    assert read(reduce.Reading(op="decompress", calls=4, stages={"device_expand": 5.0}, work={},
                               devices=[0])) is None


def test_a_broken_plane_route_and_the_control_are_not_correct(monkeypatch):
    """At a small size on the plain versions: two unequal decoded symbols
    swapped where the plane route's symbols enter the output (a swap keeps
    the bits they span, so the decode's own bit check passes and every call
    returns a wrong output), and the control (a decode without
    self-synchronisation), each make the new decode cell not ``correct``."""
    import time

    from entreepy_tpu_torch.ops import decode8
    from etbench.control import control_checks
    from etbench.run import Port, execute

    cell = _cell(48_000)
    got = control_checks(cell, 99)
    assert got["correct"] is False and got["checks"]["mismatched_bytes"]["value"] > 0
    real = decode8.extract_plane_symbols

    def altered(syms, room):
        out = np.array(real(syms, room), copy=True)
        i = out.size // 2
        j = i + 1 + int(np.flatnonzero(out[i + 1:] != out[i])[0])
        out[[i, j]] = out[[j, i]]
        return out

    monkeypatch.setattr(decode8, "extract_plane_symbols", altered)
    res = execute(cell, 2**31 + 11, 0.3, False, Port(cell, device="cpu"), time.perf_counter())
    checks = res["checks"]
    assert res["correct"] is False and checks["mismatched_bytes"]["value"] > 0
    assert checks["failed_calls"]["value"] == 0
