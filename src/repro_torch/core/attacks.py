"""Byzantine fault and attack models (Sec. IV), in PyTorch.

Update-level (model poisoning) attacks transform the would-be-honest
flat update z_j; data-level attacks (label flip, backdoor) transform the
client's local batch before training.  ``scale`` is the model
replacement attack of Bagdasaryan et al. [45] used for the backdoor.

Each random draw takes a ``torch.Generator`` or an explicit array, so a
test can hand the port the draws the reference made.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    kind: str = "none"        # none|gaussian|sign_flip|same_value|label_flip|backdoor|scale
    sigma: float = 1e4        # gaussian / same-value magnitude
    scale: float = 5.0        # backdoor model-replacement factor
    source_class: int = 3     # backdoor: relabel source -> target
    target_class: int = 4


UPDATE_ATTACKS = ("gaussian", "sign_flip", "same_value", "scale")


def attack_update(update: torch.Tensor, kind: str, cfg: AttackConfig,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat update(s) -> corrupted update(s), elementwise over any shape.

    ``gaussian`` returns ``noise * sigma`` where ``noise`` is a standard
    normal array of the update's shape: given explicitly, or drawn from
    ``generator``."""
    if kind == "gaussian":
        if noise is None:
            noise = torch.randn(update.shape, generator=generator,
                                dtype=update.dtype, device=update.device)
        return noise.to(update.dtype) * cfg.sigma
    if kind == "sign_flip":
        return -update
    if kind == "same_value":
        return torch.full_like(update, cfg.sigma)
    if kind in ("backdoor", "scale"):
        # "backdoor" is the model replacement factor of [45] (the data is
        # already poisoned), "scale" the stealthy factor probing C2's band
        return update * cfg.scale
    return update


def flip_labels(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Label-flip fault: class c -> (n_classes - 1 - c)  (paper: c_n - c)."""
    return (n_classes - 1 - labels).to(labels.dtype)


def poison_backdoor(x: torch.Tensor, y: torch.Tensor, cfg: AttackConfig,
                    frac: float = 0.5):
    """Relabel ~frac of the source-class examples to the target class and
    stamp a trigger (a bright 3x3 corner patch on images, the first 3
    features of flat inputs) on them.  ``y`` is (..., M): leading axes
    (clients) are independent batches; ``x`` is y's shape plus features."""
    is_src = y == cfg.source_class
    n_take = torch.clamp((is_src.sum(-1, keepdim=True) * frac)
                         .to(torch.int32), min=1)
    sel = is_src & (torch.cumsum(is_src.to(torch.int32), -1) <= n_take)
    y2 = torch.where(sel, torch.full_like(y, cfg.target_class), y)
    feat = x.dim() - y.dim()
    patch = (slice(None),) * y.dim() + \
        ((slice(0, 3), slice(0, 3)) if feat >= 2 else (slice(0, 3),))
    m = sel.reshape(sel.shape + (1,) * feat)
    x2 = x.clone()
    x2[patch] = torch.where(m, torch.ones_like(x[patch]), x[patch])
    return x2, y2


def make_byzantine_mask(n_clients: int, f: int,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> torch.Tensor:
    """Byzantine identities, fixed across rounds (as in the paper).
    Default: evenly spaced over the client index, so that with the
    sorted-shard partition every class keeps a benign holder.  A
    ``generator`` permutes them at random."""
    mask = torch.zeros((n_clients,), dtype=torch.bool, device=device)
    if f > 0:
        # the reference's float32 linspace, stop * (i / (f - 1)) in IEEE
        # arithmetic, then round-half-even.  Where a position is exactly
        # k + 0.5 the reference's compiled division may land one ulp off
        # and round the other way; every other id is the reference's
        stop = np.float32(n_clients - 1)
        pos = np.zeros(1, np.float32) if f == 1 else np.append(
            stop * (np.arange(f - 1, dtype=np.float32) / np.float32(f - 1)),
            stop)
        mask[torch.from_numpy(np.round(pos).astype(np.int64)).to(
            mask.device)] = True
    if generator is not None:
        perm = torch.randperm(n_clients, generator=generator,
                              device=generator.device).to(mask.device)
        mask = mask[perm]
    return mask
