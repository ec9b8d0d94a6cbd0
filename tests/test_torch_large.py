"""``tools/large_check.py`` (``chip_smoke.py``'s ``[large]`` phase) on
``device="cpu"`` (the kernels' plain versions), at small sizes with the
thresholds that the full configurations cross lowered to match: the tile
widths, the untiled two-pass routes' bound and the sharded decode's escape.
Every call of the phase runs, each result byte-exact, and the phase's own
checks hold: the random body at its minimum, the sharded escape into the
tiled decode, ``split`` and ``fused`` refused past their bound."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import large_check as lg  # noqa: E402

from entreepy_tpu_torch import compress  # noqa: E402
from entreepy_tpu_torch.bench import make_corpus  # noqa: E402
from entreepy_tpu_torch.format import parse_header  # noqa: E402
from entreepy_tpu_torch.ops import (  # noqa: E402
    cuda_compact, cuda_fsm8, cuda_pack, cuda_symbols, decode8, encode,
)
from entreepy_tpu_torch.parallel import dist as pdist  # noqa: E402

KERNELS = (cuda_fsm8.sync_pass, cuda_fsm8.fused_pass, cuda_fsm8.emit_pass,
           cuda_fsm8.expand_pass_split, cuda_fsm8.expand_pass, cuda_pack.pack_blocks,
           cuda_compact.compact_rows, cuda_symbols.symbol_counts, cuda_symbols.write_symbols)
RANDOM_BYTES = 80_000  # 256 codes of 8 bits: an 80,000 B body, 157 lanes of 512 B


def test_large_phase_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(decode8, "TILE_LANES", 32)
    monkeypatch.setattr(encode, "TILE_BLOCKS", 16)
    monkeypatch.setattr(decode8, "MAX_UNTILED_BYTES", 70_000)
    monkeypatch.setattr(pdist, "_INT32_SAFE_BODY", 70_000)
    configs = (lg.Config("text", "text", 100_000), lg.Config("random", "random", RANDOM_BYTES))
    checked = []
    lg.run(torch.device("cpu"), "cpu", KERNELS, configs, lg.Config("ref", "text", 40_000),
           body_min=RANDOM_BYTES,
           check=lambda cfg, data, blob: checked.append((cfg, len(data), blob)))
    assert [c[:2] for c in checked] == [(c, c.n_bytes) for c in configs]
    assert all(blob == compress(make_corpus(c.kind, c.n_bytes), backend="host")
               for c, _, blob in checked)
    out = capsys.readouterr().out
    assert out.count("result exact") == 2 + 2 * 6
    assert "random: body 80000 B, 157 lanes, 5 decode tiles, 5 encode tiles, 256 codes of 8-8 bits" in out
    assert "text decompress sharded world 1 onepass (untiled)" in out
    assert "random: the sharded decode took the tiled escape" in out
    for route in ("split", "fused"):
        assert f"random decompress device expand={route}: NotImplementedError" in out
    assert "peak device not measured" in out and "[large] phase" in out


@pytest.mark.parametrize("kind,n_bytes", [("text", 100_000), ("random", RANDOM_BYTES),
                                          ("skewed", 60_000)])
def test_large_kernel_windows_match_whole_shape(kind, n_bytes, monkeypatch):
    """``chip_smoke.large_kernel_checks`` on ``device="cpu"``: each wrapper
    runs its plain version there, so the whole-shape call and the plain
    version on the last window must agree exactly. That holds only if
    each window gets the entries, ``n_valid`` and blocks of its own lanes,
    so a difference on the card is the kernel's. Every kernel of the
    [large] path is compared, the untiled ones on the last lanes or
    blocks."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEV", torch.device("cpu"))
    monkeypatch.setattr(cs, "kernel_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, *a: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "timed", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(cs, "LARGE_WINDOW", 40)
    monkeypatch.setattr(cs, "TILE_BLOCKS", 16)
    monkeypatch.setattr(decode8, "TILE_LANES", 32)
    data = make_corpus(kind, n_bytes)
    blob = compress(data, backend="host")
    got = cs.large_kernel_checks(data, blob)
    assert {fn for fn, _, _ in got} == set(lg.PATH_KERNELS)
    assert all(res[0] == 0 for _, _, res in got)
    lanes = -(-(len(blob) - parse_header(blob).body_start) // decode8.DEFAULT_CHUNK_BYTES)
    blocks = -(-len(data) // encode.DEFAULT_BLOCK_BYTES)
    windows = [label for _, label, _ in got if "compared" in label]
    assert len(windows) == 5  # sync, emit, the sharded fused pass; pack, compaction
    assert all(f"lanes {lanes - 40}-{lanes - 1} compared" in w for w in windows[:3])
    assert all(f"blocks {blocks - 40}-{blocks - 1} compared" in w for w in windows[3:])


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_kernel_checks_at_rank_slices(world, monkeypatch, capsys):
    """``chip_smoke.shadow_checked`` over a local mesh of ``world`` CPU
    ranks: every kernel the calls reach is held against its plain version
    on the inputs each rank's call gave it, the untiled ones on the last
    LARGE_WINDOW lanes or blocks; the calls stay exact, the wrappers are
    restored after, and no launch is counted."""
    import chip_smoke as cs
    from entreepy_tpu_torch.ops import bitpack
    from entreepy_tpu_torch.parallel import dist as pdist
    from entreepy_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(cs, "LARGE_WINDOW", 40)
    data = make_corpus("text", 200_000)
    blob = compress(data, backend="host")
    mesh = make_mesh(devices=["cpu"] * world)
    merged = {}
    calls = [("compress", lambda: pdist.compress_sharded(data, mesh), blob)] + [
        (route, lambda r=route: pdist.decompress_sharded(blob, mesh, expand=r), data)
        for route in decode8.EXPAND_MODES]
    before = {fn: fn.launches for fn in KERNELS}
    cs.shadow_checked("cpu mesh", calls, lambda fn, res: merged.__setitem__(fn, res), "cpu")
    assert set(merged) == set(KERNELS)
    assert all(res[0] == 0 for res in merged.values())
    assert {fn: fn.launches for fn in KERNELS} == before
    assert decode8.sync_pass is cuda_fsm8.sync_pass
    assert bitpack.compact_rows is cuda_compact.compact_rows
    assert pdist.pack_blocks is cuda_pack.pack_blocks
    out = capsys.readouterr().out
    lanes = -(-(-(-(len(blob) - parse_header(blob).body_start) // decode8.DEFAULT_CHUNK_BYTES))
              // world)
    assert "sync_pass against its plain version in" in out
    assert "'last 40')" in out and f", {lanes}," in out


def test_mesh_kernel_checks_catch_a_difference(monkeypatch):
    """A kernel whose result differs from its plain version at a rank's
    shapes fails the check, in the caller of the mesh."""
    import chip_smoke as cs
    from entreepy_tpu_torch.parallel import dist as pdist
    from entreepy_tpu_torch.parallel import make_mesh

    data = make_corpus("text", 60_000)
    blob = compress(data, backend="host")
    mesh = make_mesh(devices=["cpu"] * 2)
    real = cuda_fsm8.sync_pass_plain

    def off_by_one(xs, ns, entries):  # one exit off where the wrapper calls it, as a kernel
        out = real(xs, ns, entries)
        return out + 1 if sys._getframe(1).f_code.co_name == "sync_pass" else out

    monkeypatch.setattr(cuda_fsm8, "sync_pass_plain", off_by_one)
    with pytest.raises(AssertionError, match="differ"):
        cs.shadow_checked("cpu mesh", [("onepass", lambda: pdist.decompress_sharded(blob, mesh),
                                        data)], lambda fn, res: None, "cpu")
