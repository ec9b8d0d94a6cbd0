"""A cell of ``BENCHMARK.json``, and everything it names, found by name.

``BENCHMARK.json`` sits at the root of the checkout, beside this package.
A cell (``workloads``) names a configuration (``configs[].file``, a JSON
file under ``configs/``) and a traffic mix (``mixes/<traffic>.json``). The
configuration names its corpus family (``corpora/<corpus>.py``). Every
end-to-end metric is read by ``e2e/<name>.py`` and every per-layer metric by
``metrics/<name>.py``, each a module with one function ``read``. No list of
names is kept in code: a new configuration, mix, family or metric is a new
file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path) -> ModuleType:
    """The module in the file ``path`` (a name may hold dots, so it is loaded
    by its path, not imported by its name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    spec = importlib.util.spec_from_file_location(f"etbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries this cell reports
    per_layer: list = field(default_factory=list)

    @property
    def op(self) -> str:
        return self.mix["op"]

    def corpus(self) -> ModuleType:
        return load_module(HERE / "corpora" / f"{self.config['corpus']}.py")


def _applies(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), with its
    configuration, its mix and the metrics it reports."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((ROOT / conf["file"]).read_text()),
        mix=json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if _applies(m, name, reported)],
    )


def reader(kind: str, metric: str):
    """``read`` of the module of ``metric`` (``kind``: "e2e" or "metrics")."""
    return load_module(HERE / kind / f"{metric}.py").read
