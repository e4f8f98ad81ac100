"""Attack gallery — reproduce Fig. 2's separation: plot (ASCII) the
C1 x C2 similarity product per client at the last eval under each attack.
Benign clients hover near +1; Byzantine clients go negative or explode.

    PYTHONPATH=src python -m repro_torch.examples.attack_gallery  # the card
    PYTHONPATH=src python -m repro_torch.examples.attack_gallery --device cpu
"""
import argparse

import numpy as np
import torch

from ..core.attacks import AttackConfig
from ..device import resolve_device
from ..fl import FLConfig, Federation, run_federated_training
from ..fl.small_models import mlp3
from ..optim import inv_sqrt_lr
from .quickstart import paper_data

ATTACKS = ("sign_flip", "label_flip", "same_value")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data, tx, ty = paper_data(dev, n_test=500)
    model = mlp3()

    rows = []
    for attack in ATTACKS:
        cfg = FLConfig(rounds=args.rounds, aggregator="diversefl",
                       attack=AttackConfig(kind=attack, sigma=1e4),
                       batch_size=50, eval_every=min(5, args.rounds),
                       l2=0.0005)
        fed = Federation.create(model, data, tx, ty, cfg,
                                torch.Generator(device=dev).manual_seed(2),
                                device=dev)
        h = run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))
        byz = fed.byz_mask.cpu().numpy()
        c = np.stack([np.asarray(v) for v in h["c1c2"]])    # (evals, 23)
        rows.append({"attack": attack, "byz": byz.tolist(),
                     "c1c2": c[-1].tolist()})
        print(f"\n=== attack: {attack} — C1xC2 per client "
              f"(last eval; B=Byzantine) ===")
        for j in range(len(byz)):
            tag = "B" if byz[j] else " "
            val = c[-1, j]
            bar = "#" * min(40, int(abs(val) * 20))
            side = "-" if val < 0 else "+"
            print(f"  client {j:2d}{tag} {val:+8.3f} {side}{bar}")
    return rows


if __name__ == "__main__":
    main()
