"""The harness finds every part of a cell as data, and BENCHMARK.json
keeps to the benchmark's contract."""
import filecmp
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench.harness import spec
from bench.tests import _tiny

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert BENCH["command"][1] == "bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_whys():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_cell_parts_load(name):
    cell = spec.load_cell(name, bench=_tiny.BENCH)
    assert cell.chips == 1
    fam = spec.family(cell.family)
    for fn in spec.FAMILY_API:
        assert callable(getattr(fam, fn))
    readers = spec.metric_readers(cell.per_layer)
    assert set(readers) == {m.name for m in cell.per_layer}
    assert cell.per_layer and "setup_s" in [m.name for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2
    assert cell.checks["checked_rounds"] >= 1
    assert cell.checks["warm_segments"] >= 0
    from bench.harness import fl
    assert cell.checks["limits"] and set(cell.checks["limits"]) <= \
        set(fl.NUMBERS)
    assert all(v is not None and v > 0 for v in cell.checks["limits"].values())


@pytest.mark.parametrize("conf", _tiny.BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_files(conf):
    data = spec.load_json(spec.ROOT / conf["file"])
    assert conf["file"].startswith("bench/configs/")
    # the family is a file of its own with what the harness calls
    assert (spec.ROOT / "bench/families" / f"{data['family']}.py").is_file()
    fam = spec.family(data["family"])
    assert all(callable(getattr(fam, fn, None)) for fn in spec.FAMILY_API)
    conf_cut, traffic_cut = fam.TINY
    assert set(conf_cut) <= set(data) and isinstance(traffic_cut, dict)
    assert set(conf["reduced"]) <= set(data)


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A new traffic mix, cell and metric are new files plus new entries:
    the harness loads the cell with no existing file edited."""
    shutil.copytree(spec.ROOT / "bench", tmp_path / "bench")
    bench = json.loads(json.dumps(BENCH))
    traffic = spec.load_json(spec.ROOT / "bench/traffic/xdevice-1024.json")
    traffic.update(n_clients=256, f=51)
    (tmp_path / "bench/traffic/xdevice-256.json").write_text(
        json.dumps(traffic))
    (tmp_path / "bench/workloads/mlp3-xdevice-256.json").write_text(
        json.dumps(spec.load_json(
            spec.ROOT / "bench/workloads/mlp3-xdevice.json")))
    (tmp_path / "bench/metrics/rounds_traced.py").write_text(
        "def read(trace, ctx):\n    return trace.rounds\n")
    bench["workloads"].append({"name": "mlp3-xdevice-256",
                               "config": "mlp3-fl",
                               "traffic": "xdevice-256", "chips": 1,
                               "why": "a quarter of the clients"})
    bench["per_layer"].append({"name": "rounds_traced", "unit": "rounds",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "round_ms",
                               "workloads": ["mlp3-xdevice-256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("mlp3-xdevice-256", root=tmp_path)
    assert cell.traffic["n_clients"] == 256
    assert [m.name for m in cell.per_layer][-1] == "rounds_traced"
    readers = spec.metric_readers(cell.per_layer, root=tmp_path)
    assert readers["rounds_traced"].read(type("T", (), {"rounds": 4}),
                                         {}) == 4


def test_a_family_is_added_by_new_files_alone(tmp_path):
    """A third family (here a copy of mlp3's file under another name) with
    its config, traffic mix, cell and entries: the cell's tiny set-up,
    measured and traced runs and comparison pass in a checkout where only
    files were added and BENCHMARK.json given entries."""
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(spec.ROOT / "bench", tmp_path / "bench", ignore=ignore)
    new = tmp_path / "bench"
    shutil.copy(new / "families/mlp3.py", new / "families/mlp3b.py")
    conf = spec.load_json(spec.ROOT / "bench/configs/mlp3-fl.json")
    conf.update(name="mlp3b-fl", family="mlp3b")
    (new / "configs/mlp3b-fl.json").write_text(json.dumps(conf))
    traffic = spec.load_json(spec.ROOT / "bench/traffic/xdevice-1024.json")
    traffic.update(n_clients=512, f=102)
    (new / "traffic/xdevice-512.json").write_text(json.dumps(traffic))
    shutil.copy(new / "workloads/mlp3-xdevice.json",
                new / "workloads/mlp3b-xdevice.json")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "mlp3b-fl",
                             "source": "https://arxiv.org/abs/2010.07541",
                             "file": "bench/configs/mlp3b-fl.json",
                             "reduced": [], "why": "a third family"})
    bench["workloads"].append({"name": "mlp3b-xdevice", "config": "mlp3b-fl",
                               "traffic": "xdevice-512", "chips": 1,
                               "why": "a third family's cell"})
    for m in bench["per_layer"]:
        if m["name"] in ("kernels_per_round", "mfu"):
            m["workloads"].append("mlp3b-xdevice")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time, torch\n"
        "torch.set_num_threads(1)\n"
        "from bench.harness import main\n"
        "from bench.tests._tiny import tiny\n"
        "cell = tiny('mlp3b-xdevice')\n"
        "out = [main.run_cell(cell, 7, 0.05, trace, 'cpu',\n"
        "                     time.perf_counter()) for trace in (0, 1)]\n"
        "print(json.dumps([cell.family, cell.traffic['n_clients']] +\n"
        "                 [r['correct'] for r in out]))\n")
    p = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, timeout=600,
        env={"PYTHONPATH": f"{tmp_path}:{spec.ROOT / 'src'}",
             "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == \
        ["mlp3b", 16, True, True]
    # no file of the benchmark was edited
    for path in (spec.ROOT / "bench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(spec.ROOT)
            assert filecmp.cmp(path, tmp_path / rel, shallow=False), rel
