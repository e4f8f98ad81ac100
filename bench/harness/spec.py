"""Find a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names every cell, its
configuration and its traffic mix, and every metric.  Each part is a
file of its own, found by its name:

* ``bench/configs/<config>.json``: the model's sizes and its family;
* ``bench/traffic/<traffic>.json``: the federated run's parameters;
* ``bench/workloads/<cell>.json``: the rounds the reference follows, the
  warm segments before the window, the segments the traced run profiles,
  and each compared number's limit;
* ``bench/families/<family>.py``: how the family's model, weights and
  data are made, which plain reference follows it, and its tiny cut for
  the CPU tests (:data:`FAMILY_API`);
* ``bench/metrics/<metric>.py``: the reader of a per-layer metric.

A later change adds a cell, a configuration, a traffic mix, a family or a
metric by adding files and entries, never by editing one that exists.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# what the harness takes from a family file: these functions, and
# ``TINY``, its (config overrides, traffic overrides) for the CPU tests
FAMILY_API = ("program_model", "param_shapes", "make_params", "to_program",
              "leaves", "from_program", "make_data", "reference",
              "model_flops")


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    bound: Optional[float] = None
    workloads: Optional[tuple] = None

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with its parts loaded."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    checks: dict
    end_to_end: tuple
    per_layer: tuple
    run_seconds: int

    @property
    def family(self) -> str:
        return self.config["family"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: run from the root of a "
                                f"checkout")
    return load_json(path)


def _metrics(entries, cell: str) -> tuple:
    out = []
    for e in entries:
        wl = e.get("workloads")
        m = Metric(name=e["name"], unit=e["unit"], better=e["better"],
                   source=e["source"], layer=e.get("layer"),
                   moves=e.get("moves"), bound=e.get("bound"),
                   workloads=None if wl is None else tuple(wl))
        if m.reported_in(cell):
            out.append(m)
    return tuple(out)


def load_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and checks read from their files."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    bench_dir = root / "bench"
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=load_json(root / conf["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=_metrics(bench["end_to_end"], name),
        per_layer=_metrics(bench["per_layer"], name),
        run_seconds=int(bench["run_seconds"]))


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (its name may hold
    characters a dotted import would not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str, root: Path = ROOT) -> ModuleType:
    """``bench/families/<name>.py``."""
    path = root / "bench" / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no family module {path}")
    return load_module(path, f"bench_family_{name}")


def metric_readers(metrics, root: Path = ROOT) -> Dict[str, ModuleType]:
    """``bench/metrics/<metric>.py`` for each per-layer metric."""
    out = {}
    for m in metrics:
        path = root / "bench" / "metrics" / f"{m.name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader {path} for metric {m.name}")
        out[m.name] = load_module(path, "bench_metric_" +
                                  m.name.replace(".", "_").replace("-", "_"))
    return out

