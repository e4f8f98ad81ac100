"""Non-IID partition of the paper's main experiment (Sec. IV-A)."""
from __future__ import annotations

import torch


def partition_sorted_shards(x: torch.Tensor, y: torch.Tensor,
                            n_clients: int):
    """Sort by class (stable), cut into n_clients contiguous subsets: each
    client sees ~1 class (extreme heterogeneity).  The stable sort makes
    the split exactly the reference's."""
    order = torch.argsort(y, stable=True)
    xs, ys = x[order], y[order]
    per = ys.shape[0] // n_clients
    return [(xs[i * per:(i + 1) * per], ys[i * per:(i + 1) * per])
            for i in range(n_clients)]
