"""The readings a cell's limits are set from: the compared numbers of
sound program runs over many seeds (the lower readings), of the control,
the plain reference computed at the next precision below the
configuration's in the program's place, and of the program with each
planted fault (the upper readings).

The program's runs stop after the followed rounds (no window).  Every
reading of one seed shares that seed's float32 reference.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Iterable, Optional

import torch

from bench.harness import faults, fl, spec

# the next precision below each configuration's compute type
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def program_outputs(cell: spec.Cell, seed: int, device,
                    fault: Optional[str] = None) -> dict:
    run = fl.FLCell(cell, seed, device, fault=fault)
    with faults.planted(fault):
        run.setup()
    out = run.program_outputs()
    run.release()
    return out


def diagnose(prog: dict, ref: dict, top: int = 5) -> dict:
    """What a reading rests on: clients kept per round on each side, the
    leaves that did not move, and the leaves of the widest gaps."""
    def kept(rows):
        return [int(((r > 0.5) & (r < 2.0)).sum()) for r in
                (torch.as_tensor(x) for x in rows)]
    gaps = sorted(((abs(prog["norms1"][k] - v) / max(v, 1e-300), k,
                    prog["norms1"][k], v) for k, v in ref["norms1"].items()),
                  reverse=True)[:top]
    widest = []
    for r, (p, q) in enumerate(zip(prog["c1c2"], ref["c1c2"])):
        p = torch.as_tensor(p, dtype=torch.float64).cpu()
        q = torch.as_tensor(q, dtype=torch.float64).cpu()
        d = (p - q).abs() / torch.clamp(q.abs(), min=float(q.abs().median()))
        j = int(d.argmax())
        widest.append([r, j, float(p[j]), float(q[j]), float(d[j])])
    return {"widest_client": widest,
            "kept_program": kept(prog["c1c2"]), "kept_reference":
            kept(ref["c1c2"]),
            "unmoved_program": sum(v == 0 for v in prog["norms1"].values()),
            "unmoved_reference": sum(v == 0 for v in ref["norms1"].values()),
            "leaves": len(ref["norms1"]),
            "median_move_reference": statistics.median(ref["norms1"].values()),
            "widest_leaves": gaps}


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def readings(cell: spec.Cell, seed: int, device, *, control: bool = False,
             fault_kinds: Iterable[str] = ()) -> Iterable[dict]:
    """One line per reading of ``seed``: the program's, then optionally
    the control's and each fault's."""
    t = time.perf_counter()
    prog = program_outputs(cell, seed, device)
    t_prog = time.perf_counter() - t
    run = fl.FLCell(cell, seed, device)
    t = time.perf_counter()
    ref = run.reference(prog["states"], "fp32")
    t_ref = time.perf_counter() - t
    yield {"seed": seed, "kind": "program", **fl.compare(prog, ref),
           "program_s": t_prog, "reference_s": t_ref,
           "diagnosis": diagnose(prog, ref)}
    # the reference's first-round params wait on the host while the card
    # runs the control and the faults
    ref["p1"] = {k: v.cpu() for k, v in ref["p1"].items()}
    _free(device)
    if control:
        mode = CONTROL[cell.config["dtype"]]
        low = run.reference(prog["states"], mode)
        yield {"seed": seed, "kind": f"control_{mode}", **fl.compare(low, ref)}
        del low
        _free(device)
    for kind in fault_kinds:
        out = program_outputs(cell, seed, device, fault=kind)
        yield {"seed": seed, "kind": f"fault_{kind}", **fl.compare(out, ref)}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated program seeds")
    p.add_argument("--control-seeds", default="",
                   help="seeds (among --seeds) that also read the control")
    p.add_argument("--fault-seeds", default="",
                   help="seeds (among --seeds) that also read the faults")
    p.add_argument("--faults", default=None,
                   help="comma-separated faults to plant on --fault-seeds "
                        "(default: every fault the cell can have)")
    p.add_argument("--out", default=None, help="also append lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    kinds = faults.kinds(cell.traffic) if args.faults is None \
        else [k for k in args.faults.split(",") if k]

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    ctl, flt = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    for seed in ints(args.seeds):
        for line in readings(cell, seed, dev, control=seed in ctl,
                             fault_kinds=kinds if seed in flt else []):
            line = {"workload": cell.name, **line}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0
