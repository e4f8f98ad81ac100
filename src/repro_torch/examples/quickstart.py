"""Quickstart — the paper in two minutes.

23 clients with extreme non-IID shards, 5 Byzantine clients attacking
their updates.  DiverseFL filters them with the per-client C1/C2 criteria
and matches OracleSGD; coordinate-median limps; undefended mean collapses
under a Gaussian attack.

    PYTHONPATH=src python -m repro_torch.examples.quickstart   # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from ..core.attacks import AttackConfig
from ..data import FederatedData, make_mnist_like, partition_sorted_shards
from ..device import resolve_device
from ..fl import (FLConfig, Federation, available_aggregators,
                  run_federated_training)
from ..fl.small_models import softmax_regression
from ..optim import inv_sqrt_lr

RUNS = (("oracle", "sign_flip"), ("diversefl", "sign_flip"),
        ("median", "sign_flip"), ("mean", "gaussian"),
        ("diversefl", "gaussian"), ("diversefl", "label_flip"))


def paper_data(dev, n_test: int = 1000):
    """The examples' federation data: 4,600 MNIST-like training examples
    (generator seed 0) in 23 sorted shards, ``n_test`` test examples (seed
    9), on ``dev``."""
    x, y = make_mnist_like(torch.Generator(device=dev).manual_seed(0), 4600)
    tx, ty = make_mnist_like(torch.Generator(device=dev).manual_seed(9),
                             n_test)
    data = FederatedData.from_partitions(partition_sorted_shards(x, y, 23),
                                         10)
    return data, tx, ty


def run(model, data, tx, ty, agg, attack, dev, seed=0, fed_seed=2):
    """One of the example's runs: ``agg`` under ``attack`` for 60 rounds,
    the round draws from ``seed`` (``FLConfig.seed``) and the federation's
    from a generator seeded ``fed_seed`` (the example's are 0 and 2).
    -> its row: ``aggregator``, ``attack``, ``acc``, ``tpr``, ``fpr``
    (None where the rule flags no one)."""
    cfg = FLConfig(rounds=60, aggregator=agg,
                   attack=AttackConfig(kind=attack, sigma=1e4),
                   batch_size=50, eval_every=60, seed=seed)
    fed = Federation.create(model, data, tx, ty, cfg,
                            torch.Generator(device=dev).manual_seed(fed_seed),
                            device=dev)
    h = run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))
    tpr = float(h["mask_tpr"][-1]) if h["mask_tpr"] else None
    fpr = float(h["mask_fpr"][-1]) if h["mask_fpr"] else None
    return {"aggregator": agg, "attack": attack,
            "acc": float(h["final_acc"]), "tpr": tpr, "fpr": fpr}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data, tx, ty = paper_data(dev)
    model = softmax_regression()

    print("registered aggregation rules:", ", ".join(available_aggregators()))
    print(f"{'aggregator':12s} {'attack':11s} {'acc':>6s} {'TPR':>5s} "
          f"{'FPR':>5s}")
    rows = []
    for agg, attack in RUNS:
        row = run(model, data, tx, ty, agg, attack, dev)
        rows.append(row)
        show = [f"{v:.2f}" if v is not None else "   -"
                for v in (row["tpr"], row["fpr"])]
        print(f"{agg:12s} {attack:11s} {row['acc']:6.3f} {show[0]:>5s} "
              f"{show[1]:>5s}")
    return rows


if __name__ == "__main__":
    main()
