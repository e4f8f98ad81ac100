"""Each cell at tiny widths, for the CPU: the same files, families and
code paths, with every size cut as the cell's family file's ``TINY``
says (no CUDA graph off the card).

``PARKED`` holds the entries of a cell whose parts stay under ``bench/``
while ``BENCHMARK.json`` leaves it out (PERF.md, Open questions), so its
set-up, comparison, control and faults stay tested until a benchmark
change brings it back."""
import dataclasses
import json

from bench.harness import spec

PARKED = {
    "configs": [{"name": "h2o-danube-1.8b-fl",
                 "file": "bench/configs/h2o-danube-1.8b-fl.json",
                 "reduced": ["rms_norm_eps"]}],
    "workloads": [{"name": "danube-silo", "config": "h2o-danube-1.8b-fl",
                   "traffic": "silo-8", "chips": 1}],
    # the per-layer metrics its traced run reads: (name, unit, better)
    "per_layer": [("device_idle_pct", "%", "lower"),
                  ("mfu", "%", "higher"),
                  ("kernels_per_round", "launches", "lower"),
                  ("model_grad_ms", "ms", "lower"),
                  ("similarity_stats_roofline", "%", "higher"),
                  ("masked_agg_update_roofline", "%", "higher")],
}


def with_parked(bench: dict) -> dict:
    """``bench`` with the parked cells added, each per-layer metric
    reported in them."""
    out = json.loads(json.dumps(bench))
    out["configs"] += PARKED["configs"]
    out["workloads"] += PARKED["workloads"]
    names = [w["name"] for w in PARKED["workloads"]]
    known = {m["name"]: m for m in out["per_layer"]}
    for name, unit, better in PARKED["per_layer"]:
        m = known.get(name)
        if m is None:
            m = {"name": name, "unit": unit, "better": better,
                 "source": "device_trace", "moves": "round_ms",
                 "workloads": []}
            out["per_layer"].append(m)
        m["workloads"] = list(m.get("workloads", [])) + names
    return out


BENCH = with_parked(spec.load_benchmark())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(name: str, **limits) -> spec.Cell:
    cell = spec.load_cell(name, bench=BENCH)
    conf, traffic = spec.family(cell.family).TINY
    checks = dict(cell.checks)
    if limits:
        checks["limits"] = dict(checks["limits"], **limits)
    return dataclasses.replace(cell, config=dict(cell.config, **conf),
                               traffic=dict(cell.traffic, **traffic),
                               checks=checks)
