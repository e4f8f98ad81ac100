"""Each cell's set-up, segment loop, reference comparison and result line,
driven through the harness's own functions at tiny widths on the CPU
with the kernels' plain versions; and the measurement entry's refusal
without a card."""
import argparse
import json
import subprocess
import sys
import time

import pytest
import torch

from bench.harness import main as hm, spec
from bench.tests._tiny import CELLS, tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2 ** 31 + 977


@pytest.mark.parametrize("name", CELLS)
def test_measured_run(name):
    cell = tiny(name)
    res = hm.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    assert res["attempted"] >= cell.traffic["eval_every"]
    assert res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(res["checks"]) == list(cell.checks["limits"]) + ["finite_params"]
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    cell = tiny(name)
    res = hm.run_cell(cell, SEED + 1, 0.2, True, "cpu", time.perf_counter())
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True, res["checks"]
    # the CPU has no device trace: only the readers of host counts read
    assert set(res["metrics"]) <= {m.name for m in cell.per_layer}
    assert res["device"]["window_s"] > 0
    assert res["attempted"] == (cell.checks["trace_segments"]
                                * cell.traffic["eval_every"])


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs(name):
    cell = tiny(name)
    fam = spec.family(cell.family)
    a = fam.make_params(cell.config, 5, "cpu")
    b = fam.make_params(cell.config, 5, "cpu")
    c = fam.make_params(cell.config, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    da = fam.make_data(cell.config, cell.traffic, 5, "cpu")
    db = fam.make_data(cell.config, cell.traffic, 5, "cpu")
    assert torch.equal(da["x"], db["x"]) and torch.equal(da["y"], db["y"])


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = argparse.Namespace(workload=CELLS[0], seed=1, seconds=1.0,
                              trace=0)
    assert hm.main(args, time.perf_counter()) == 2
    assert capsys.readouterr().out == ""


def test_entry_point_prints_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, str(spec.ROOT / "bench/run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
