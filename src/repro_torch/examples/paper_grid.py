"""Reproduce a small Table-style results grid in ONE invocation.

The paper's tables sweep attack kind x aggregator x seed; the sweep
engine (fl/sweep.py) runs the whole grid by structural group: cells
sharing a structure (same attack kind + aggregator here) run on one
engine, built once, with one host sync per group, and each cell's result
is bitwise its solo run.

    PYTHONPATH=src python -m repro_torch.examples.paper_grid     # the card
    PYTHONPATH=src python -m repro_torch.examples.paper_grid --device cpu
"""
import argparse
import time

import numpy as np
import torch

from ..core.attacks import AttackConfig
from ..device import resolve_device
from ..fl import (FLConfig, Federation, SweepSpec, group_cells,
                  run_federated_sweep, trace_counter)
from ..fl.small_models import softmax_regression
from ..optim import inv_sqrt_lr
from .quickstart import paper_data

ATTACKS = (AttackConfig(kind="gaussian", sigma=1e4),
           AttackConfig(kind="sign_flip"),
           AttackConfig(kind="label_flip"),
           AttackConfig(kind="backdoor", source_class=3, target_class=4))
AGGREGATORS = ("diversefl", "oracle", "mean", "fltrust")
SEEDS = (0, 1, 2)


def main(argv=None):
    """Returns one row per cell, in ``SweepSpec.cells()`` order
    (aggregator outermost, then attack, seeds inner)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data, tx, ty = paper_data(dev)
    model = softmax_regression()

    base = FLConfig(rounds=args.rounds, batch_size=50,
                    eval_every=args.rounds)
    spec = SweepSpec(base=base, seeds=SEEDS, aggregators=AGGREGATORS,
                     attacks=ATTACKS)
    cells = spec.cells()
    fed = Federation.create(model, data, tx, ty, base,
                            torch.Generator(device=dev).manual_seed(2),
                            device=dev)

    with trace_counter() as tc:
        t0 = time.time()
        results = run_federated_sweep(model, fed, spec, inv_sqrt_lr(0.05))
        dt = time.time() - t0
    print(f"{len(cells)} runs in {dt:.1f}s "
          f"({len(cells) / dt:.2f} experiments/sec), "
          f"{tc['build']} engine builds and {tc['capture']} graph captures "
          f"for {len(group_cells(cells))} structural groups\n")

    rows = [{"aggregator": c.cfg.aggregator, "attack": c.cfg.attack.kind,
             "seed": c.cfg.seed, "final_acc": float(r["final_acc"])}
            for c, r in zip(cells, results)]
    print(f"final accuracy, mean ± spread over {len(SEEDS)} seeds "
          f"({args.rounds} rounds, 23 clients, f=5):")
    print("attack      " + "".join(f"{a:>16s}" for a in AGGREGATORS))
    for ai, atk in enumerate(ATTACKS):
        row = f"{atk.kind:12s}"
        for gi in range(len(AGGREGATORS)):
            accs = [rows[(gi * len(ATTACKS) + ai) * len(SEEDS) + s]
                    ["final_acc"] for s in range(len(SEEDS))]
            row += f"{np.mean(accs):10.3f}±{np.std(accs):.3f}"
        print(row)
    return rows


if __name__ == "__main__":
    main()
