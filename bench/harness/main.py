"""One run of one cell: refuse without the card, set up, measure or trace,
compare with the reference, and print the result's one line.

The measured run (``--trace 0``) reports the cell's end-to-end metrics;
the traced run (``--trace 1``) profiles ``trace_segments`` segments and
reports the per-layer metrics, the device's busy and window seconds and
the breakdown.  Both decide ``correct`` the same way and print each
compared number beside its limit, last on standard error and last in the
result's line.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from bench.counts import kernels
from bench.harness import fl, spec
from bench.harness import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is not ``repro``: the whole name is compared)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def layer_context(cell: spec.Cell) -> dict:
    fam = spec.family(cell.family)
    dt = cell.config["dtype"]
    return {"model_flops_per_round": fam.model_flops(cell.config,
                                                     cell.traffic),
            "peak_flops": kernels.PEAK_FLOPS[dt], "traffic": cell.traffic,
            "d": kernels.flat_dim(fam.param_shapes(cell.config))}


def per_layer(cell: spec.Cell, trace: tr.Trace) -> dict:
    """Each per-layer metric its reader finds something to read for."""
    readers = spec.metric_readers(cell.per_layer)
    ctx = layer_context(cell)
    out = {}
    for m in cell.per_layer:
        v = readers[m.name].read(trace, ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Run the cell and return the result's fields (no printing)."""
    run = fl.FLCell(cell, seed, device, ranged=trace)
    run.setup()
    dev = torch.device(device)
    res = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
           "device": {}}
    extra = {}
    if trace:
        t, peak = run.traced_window(int(cell.checks["trace_segments"]))
        res["metrics"] = per_layer(cell, t)
        extra = {"busy_s": tr.busy_us(t) / 1e6, "window_s": t.window_us / 1e6}
        res["breakdown"] = tr.breakdown(t)
        log(f"traced {t.rounds} rounds: {len(t.kernels)} kernels, "
            f"{len(t.marks)} phase marks, {len(t.device)} device ops, "
            f"{len(t.events)} recorded events, window "
            f"{extra['window_s']:.6f} s")
    else:
        t_window = time.perf_counter()
        w = run.window(seconds)
        peak = w["peak_bytes"]
        values = {"round_ms": w["round_ms"], "peak_gib": w["peak_bytes"] / GIB,
                  "setup_s": t_window - t_start}
        res["metrics"] = {m.name: {"value": values[m.name], "unit": m.unit}
                          for m in cell.end_to_end if m.name in values}
        log(f"window: {w['rounds']} rounds in {w['seconds']:.6f} s")
    res["attempted"] = run.rounds
    res["failed"] = run.failed_rounds
    finite = run.finite_params()
    mem_peak = max(peak, run.setup_peak)
    prog = run.program_outputs()
    run.release()
    t_ref = time.perf_counter()
    ref = run.reference(prog["states"])
    log(f"reference: {run.k} rounds in {time.perf_counter() - t_ref:.3f} s")
    ok, checks = fl.judge(fl.compare(prog, ref), cell.checks["limits"])
    res["correct"] = bool(ok and finite and res["failed"] == 0)
    res["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu",
                     "count": cell.chips, "memory_peak_bytes": int(mem_peak),
                     **extra}
    res["checks"] = dict(checks, finite_params={"value": int(finite),
                                                "limit": 1})
    return res


def main(args, t_start: float) -> int:
    if not torch.cuda.is_available():
        log("error: no CUDA device; the benchmark runs on the card only")
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"error: {cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   t_start)
    bad = forbidden_modules()
    if bad:
        log(f"error: the run loaded {bad}: the benchmark runs the PyTorch "
            f"port alone")
        return 3
    for k, v in res["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0
