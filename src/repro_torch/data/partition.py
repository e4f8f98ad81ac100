"""Non-IID partitioners (Sec. IV-A: sort-by-class sharding; Appendix B-2:
two random shards per client after [3]; plus Dirichlet for ablations).

The random partitions draw from ``np.random.default_rng(seed)`` exactly as
the reference does, so the same seed gives the reference's clients; the
index arrays then cut the tensors on their own device.
"""
from __future__ import annotations

import numpy as np
import torch


def _class_order(y: torch.Tensor) -> np.ndarray:
    """Indices that sort the labels by class, stably (numpy's stable sort,
    as the reference uses)."""
    return np.argsort(y.detach().cpu().numpy(), kind="stable")


def _take(t: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    return t[torch.from_numpy(np.asarray(idx, np.int64)).to(t.device)]


def partition_sorted_shards(x: torch.Tensor, y: torch.Tensor,
                            n_clients: int):
    """Sort by class (stable), cut into n_clients contiguous subsets: each
    client sees ~1 class (extreme heterogeneity)."""
    order = _class_order(y)
    per = len(order) // n_clients
    return [(_take(x, order[i * per:(i + 1) * per]),
             _take(y, order[i * per:(i + 1) * per]))
            for i in range(n_clients)]


def partition_two_shards(x: torch.Tensor, y: torch.Tensor, n_clients: int,
                         seed: int = 0, shards_per_client: int = 2):
    """[3]-style: sort by class, cut into 2*N shards, deal each client
    `shards_per_client` random shards (Appendix B-2 setting)."""
    rng = np.random.default_rng(seed)
    order = _class_order(y)
    n_shards = n_clients * shards_per_client
    per = len(order) // n_shards
    shard_ids = rng.permutation(n_shards)
    out = []
    for c in range(n_clients):
        ids = shard_ids[c * shards_per_client:(c + 1) * shards_per_client]
        rows = np.concatenate([order[i * per:(i + 1) * per] for i in ids])
        out.append((_take(x, rows), _take(y, rows)))
    return out


def partition_dirichlet(x: torch.Tensor, y: torch.Tensor, n_clients: int,
                        alpha: float = 0.3, seed: int = 0, n_classes=None):
    """Dirichlet(alpha) label-skew partition (standard non-IID benchmark)."""
    rng = np.random.default_rng(seed)
    y_np = y.detach().cpu().numpy()
    n_classes = n_classes or int(y_np.max()) + 1
    idx_by_class = [np.where(y_np == c)[0] for c in range(n_classes)]
    client_idx = [[] for _ in range(n_clients)]
    for idxs in idx_by_class:
        rng.shuffle(idxs)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for c, part in enumerate(np.split(idxs, cuts)):
            client_idx[c].extend(part.tolist())
    return [(_take(x, np.asarray(ci, int)), _take(y, np.asarray(ci, int)))
            for ci in client_idx]
