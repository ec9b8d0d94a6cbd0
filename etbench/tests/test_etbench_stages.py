"""``etbench.stages`` on the CPU: its readers on canned profiler events and
counts, and a window of each cell through the port's plain versions at a
small size.

Run from the root of a checkout: ``python -m pytest etbench/tests -q``.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from etbench import reduce, stages
from etbench.cells import load_cell
from etbench.run import Port

SMALL = 48_000


def _ev(name, start, end, dev="CPU", thread=1, user=True):
    """A canned ``prof.events()`` entry, times in µs."""
    return SimpleNamespace(name=name, device_type=f"DeviceType.{dev}", device_index=0,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=user, thread=thread)


# one decompress call, 0-1000 µs on thread 1; rank-style work on thread 2
EVENTS = [
    _ev(reduce.CALL_SPAN, 0, 1000), _ev(reduce.CALL_SPAN, 5, 995, dev="CUDA"),
    _ev("entreepy.decompress", 10, 990),
    _ev("entreepy.decode_tables", 20, 120), _ev("entreepy.fsm_build", 30, 100),
    _ev("entreepy.body_upload", 130, 150), _ev("entreepy.body_upload", 131, 149, dev="CUDA"),
    _ev("entreepy.host_extract", 300, 900),
    _ev("entreepy.host_extract", 0, 1000, thread=2),
    _ev("fused_kernel", 140, 260, dev="CUDA", user=False),
    _ev("aten::copy_", 130, 150, user=False),
]


def test_program_spans_are_the_host_side_ranges():
    got = stages.program_spans(EVENTS)
    assert [(n, t) for n, _, _, t in got] == [
        ("entreepy.host_extract", 2), ("entreepy.decompress", 1),
        ("entreepy.decode_tables", 1), ("entreepy.fsm_build", 1),
        ("entreepy.body_upload", 1), ("entreepy.host_extract", 1)]
    assert got[1][1:3] == (pytest.approx(10e-6), pytest.approx(990e-6))


def test_api_self_time_leaves_out_the_stages_on_its_thread():
    """980 µs less decode_tables (100, fsm_build inside it), body_upload
    (20) and host_extract (600); another thread's ranges count for nothing."""
    got = stages.self_ms(stages.program_spans(EVENTS), "decompress")
    assert got == [pytest.approx((980 - 100 - 20 - 600) * 1e-3)]
    assert stages.self_ms(stages.program_spans(EVENTS), "compress") == []


def test_stage_at_takes_the_innermost_range():
    spans = stages.program_spans(EVENTS)
    assert stages.stage_at(spans, 1, 50e-6) == "fsm_build"
    assert stages.stage_at(spans, 1, 110e-6) == "decode_tables"
    assert stages.stage_at(spans, 1, 200e-6) == "decompress"
    assert stages.stage_at(spans, 2, 200e-6) == "host_extract"
    assert stages.stage_at(spans, 1, 995e-6) is None


def _reading(events):
    ev, spans = reduce.timeline(events)
    return reduce.Reading(op="decompress", calls=1, stages={}, work={}, devices=[0],
                          events=ev, spans=spans)


def test_idle_gaps_are_named_by_the_stage_over_their_midpoint():
    """The gap from 260 to 1000 µs has its midpoint in host_extract; the one
    from 0 to 140 in fsm_build, inside decode_tables. A gap that no range
    covers keeps the label ``reduce.breakdown`` gives it."""
    r = _reading(EVENTS)
    spans = stages.program_spans(EVENTS)
    got = stages.named_gaps(r, spans)
    assert got == [["cuda:0 idle in decompress call 0 at host_extract", pytest.approx(740e-6)],
                   ["cuda:0 idle in decompress call 0 at fsm_build", pytest.approx(140e-6)]]
    bare = stages.named_gaps(r, [])
    assert [g[0] for g in bare] == [g[0] for g in reduce.breakdown(r)["idle_gaps"]]


def test_program_ranges_on_the_card_are_no_device_work():
    """The ranges' copies on the card's timeline are user annotations:
    ``reduce.timeline`` leaves them out, so the device's idle share and the
    kernels' time read the same with them and without."""
    plain = [e for e in EVENTS if not (e.name.startswith("entreepy.") and "CUDA" in e.device_type)]
    with_ranges, without = _reading(EVENTS), _reading(plain)
    assert [e.name for e in with_ranges.events] == ["fused_kernel"]
    assert reduce.idle_pct(with_ranges) == reduce.idle_pct(without)
    assert reduce.kernel_s(with_ranges) == reduce.kernel_s(without)
    assert reduce.roofline_pct(with_ranges, 1e6) == reduce.roofline_pct(without, 1e6)


def test_readings_from_counts_and_spans():
    counts = {"h2d_bytes": 3_000_000, "d2h_bytes": 9_000_000, "plane_slots": 1000,
              "symbols": 568, "fsm_builds": 2}
    got = stages.readings("decompress", 2, counts, stages.program_spans(EVENTS))
    assert got == {"decode_api_self_ms": pytest.approx(0.26), "decode_link_MB": 6.0,
                   "decode_plane_fill": pytest.approx(56.8), "decode_fsm_builds": 1.0}
    enc = stages.readings("compress", 4, {"h2d_bytes": 8_000_000}, [])
    assert enc == {"encode_api_self_ms": None, "encode_link_MB": 2.0}


def test_readings_find_nothing_without_their_input():
    """A program without the ranges and counts reads None everywhere; a
    record with counts but no build reads 0 builds."""
    assert set(stages.readings("decompress", 3, {}, []).values()) == {None}
    assert set(stages.readings("compress", 3, {}, []).values()) == {None}
    assert stages.readings("decompress", 3, {"h2d_bytes": 1}, [])["decode_fsm_builds"] == 0


@pytest.mark.parametrize("name", ["text-5.2MB.decode", "text-100MB.encode"])
def test_a_window_on_the_plain_versions(name):
    cell = load_cell(name)
    cell.config["doc_bytes"] = SMALL
    res = stages.window(cell, 2**31 + 5, 3, Port(cell, device="cpu"))
    assert res["wrong_outputs"] == 0 and res["calls"] == 3
    got = res["readings"]
    assert all(v is not None for v in got.values()), got
    side = "decode" if cell.op == "decompress" else "encode"
    assert 0 <= got[f"{side}_api_self_ms"] < res["call_ms"]
    assert got[f"{side}_link_MB"] > SMALL / 1e6
    if side == "decode":
        assert 50 < got["decode_plane_fill"] < 70
        assert got["decode_fsm_builds"] == 1.0  # every call under a table of its own
        assert "fsm_build" in res["stages_ms"] and "join_output" in res["stages_ms"]
    else:
        assert "join_tiles" in res["stages_ms"]
    assert res["device_idle_pct"] is None and res["idle_gaps"] == []  # no card
    json.dumps(res)
