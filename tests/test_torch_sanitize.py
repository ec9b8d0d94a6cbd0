"""The sanitizer tools of the port, kept from rotting on the CPU.

* ``tools/_sanitize_torch_driver.py`` (the driver of ``tools/sanitize_torch.sh``)
  run uninstrumented: it reaches all 12 entry points of the host runtime;
* the 39 kernel instantiations of ``tools/sanitize_kernels.py`` against the
  dispatch code of ``csrc/``, and its calls, which reach them, through the
  plain versions;
* its guard bands, on faults made on purpose and on every call.
"""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import sanitize_kernels as sk  # noqa: E402

from entreepy_tpu_torch import runtime  # noqa: E402

def test_host_driver_names_every_entry_point():
    """The driver of tools/sanitize_torch.sh, uninstrumented: every entry
    point of runtime._ENTRIES is called."""
    r = subprocess.run([sys.executable, "tools/_sanitize_torch_driver.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    for name, _, _ in runtime._ENTRIES:
        line = next(ln for ln in r.stdout.splitlines() if f" {name} " in ln)
        assert int(line.split()[-2]) > 0, line
    assert f"all {len(runtime._ENTRIES)} entry points reached" in r.stdout


def test_sanitize_script_rejects_unknown_tool():
    r = subprocess.run(["bash", "tools/sanitize_torch.sh", "msan"], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 2 and "usage" in r.stderr


def test_instantiations_are_the_sources():
    """INSTANTIATIONS names exactly the instantiations the dispatch code of
    csrc/ names, 39 of them."""
    assert len(sk.INSTANTIATIONS) == len(set(sk.INSTANTIATIONS)) == 39
    assert sk.source_instantiations() == set(sk.INSTANTIATIONS)


@pytest.mark.parametrize("rule,args,want", [
    # expand.cu: staged exactly for 4-byte entries that fit the opt-in limit
    (sk.expand_instantiation, (1, 128), "expand_kernel<2, 4, true>"),
    (sk.expand_instantiation, (3, 128), "expand_kernel<4, 4, true>"),
    (sk.expand_instantiation, (1, 256), "expand_kernel<2, 4, false>"),
    (sk.expand_instantiation, (3, 128, 100_000), "expand_kernel<4, 4, false>"),
    (sk.expand_instantiation, (4, 128), "expand_kernel<5, 8, false>"),
    (sk.expand_instantiation, (7, 256), "expand_kernel<8, 8, false>"),
    (sk.expand_instantiation, (8, 128), "expand_kernel<9, 16, false>"),
    # fsm8.cu: NT = min(mt, m - 1), packed rows one instantiation
    (sk.fused_instantiation, (1, 1, False), "fused_kernel<false, 0>"),
    (sk.fused_instantiation, (8, 7, False), "fused_kernel<false, 7>"),
    (sk.fused_instantiation, (3, 2, True), "fused_kernel<true, 2>"),
    (sk.split_instantiation, (1, 1), "expand_split_kernel<0>"),
    (sk.split_instantiation, (5, 4), "expand_split_kernel<4>"),
    # pack.cu: 16-byte loads for steps % 16 == 0 on an aligned base
    (sk.pack_instantiation, (1024, 0x7F0000001000), "pack_kernel<true>"),
    (sk.pack_instantiation, (100, 0x7F0000001000), "pack_kernel<false>"),
    (sk.pack_instantiation, (1024, 0x7F0000001008), "pack_kernel<false>"),
    # compact.cu: the serial kernel past the tile's cap or grid
    (sk.compact_instantiation, (1536, 1), "compact_tile_kernel"),
    (sk.compact_instantiation, (1537, 1), "compact_serial_kernel"),
    (sk.compact_instantiation, (64, 65536), "compact_serial_kernel"),
    (sk.walk_instantiation, (True,), "walk_kernel<true>"),
    # symbols.cu: the packed form's two launches and the plane form's write
    (sk.symbols_instantiation, (False, False), "symbols_kernel<false, false>"),
    (sk.symbols_instantiation, (True, True), "symbols_kernel<true, true>"),
])
def test_dispatch_rule(rule, args, want):
    assert rule(*args) == want


def test_plan_reaches_every_instantiation():
    """The calls, laid out on the CPU: by the dispatch rules they
    reach all 39 instantiations, at lanes 1, 7, 33 and 300."""
    calls = sk.plan("cpu")
    assert {c.instantiation for c in calls} == set(sk.INSTANTIATIONS)
    for lanes in (1, 7, 33, 300):
        assert any(f"lanes={lanes} " in c.label + " " for c in calls), lanes


@pytest.mark.parametrize("demangled,want", [
    ("void (anonymous namespace)::walk_kernel<(bool)1>(const unsigned char *, int)",
     "walk_kernel<true>"),
    ("void (anonymous namespace)::expand_kernel<2, 4, true>(unsigned char const*, int)",
     "expand_kernel<2, 4, true>"),
    ("(anonymous namespace)::compact_serial_kernel(int const*, int)", "compact_serial_kernel"),
])
def test_kernel_name(demangled, want):
    assert sk.kernel_name(demangled) == want


def test_child_runs_on_cpu():
    """The script end to end through the plain versions: every call runs
    and the API round trips are exact."""
    r = subprocess.run([sys.executable, "tools/sanitize_kernels.py", "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reached 39/39 instantiations" in r.stdout
    assert r.stdout.count(": exact") == 9


# ---- the guard bands ----

def _clean(x):
    o = torch.empty(x.numel(), dtype=torch.uint8)
    o.copy_(x.reshape(-1))
    return o


def _write_past_end(x):
    o = _clean(x)
    torch.as_strided(o, (o.numel() + 1,), (1,), o.storage_offset())[-1] = 7
    return o


def _leave_one_unwritten(x):
    o = torch.empty(x.numel(), dtype=torch.uint8)
    o[:-1] = x.reshape(-1)[:-1]
    return o


def _read_past_end(x):
    return torch.as_strided(x, (x.numel() + 1,), (1,), x.storage_offset()).clone()


def _write_input(x):
    x[0] = 1
    return _clean(x)


@pytest.mark.parametrize("fn,fault", [
    (_clean, None),
    (_write_past_end, "guard band overwritten"),
    (_leave_one_unwritten, "outputs differ between poisons"),
    (_read_past_end, "outputs differ between poisons"),
    (_write_input, "wrote into its input"),
])
def test_guard_finds_faults(fn, fault):
    """Each fault a guard band shows, made on purpose by a fake wrapper."""
    x = torch.arange(40, dtype=torch.uint8).reshape(5, 8) + 2
    faults = sk.guard_calls([sk.Call("fake", "none", fn, (x,))], torch.device("cpu"))
    if fault is None:
        assert faults == []
    else:
        assert faults and all(f.startswith("fake") for f in faults)
        assert any(fault in f for f in faults), faults


def test_guard_plan_on_cpu():
    """Every call, guarded, through the plain versions: no fault."""
    assert sk.guard_calls(sk.plan("cpu"), torch.device("cpu")) == []


@pytest.mark.parametrize("m", [1, 3, 4, 7, 8])
def test_vector_table_pad_is_written(m):
    """The full-table expansion's relaid table: the kernel loads each
    entry's pad bytes with it, so the relayout writes them (0); under a
    poisoned guard nothing of the table is left as it was allocated."""
    from entreepy_tpu_torch.ops import cuda_fsm8

    m1 = m + 1
    t_exp = torch.arange(256 * m1 * 128, dtype=torch.int64).remainder(251).to(torch.uint8)
    with sk.Guard(0xA5):
        vec = cuda_fsm8.expand_vector_table(t_exp.reshape(256, m1 * 128), m)
    p = vec.shape[2]
    assert p == (4 if m1 <= 4 else 8 if m1 <= 8 else 16)
    assert torch.equal(vec[:, :, :m1], t_exp.view(256, m1, 128).transpose(1, 2))
    assert bool((vec[:, :, m1:] == 0).all())
