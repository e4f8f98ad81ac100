"""Step 0/1 — sample-poisoning mitigation (Sec. III-A, IV-C), in PyTorch.

The FL administrator pre-trains a clean model on a small known-clean
dataset; each client's shared enclave sample is scored with it, and
clients whose sample accuracy falls below the threshold T are flagged as
poisoned and dropped from training.  All of this executes "inside" the
enclave (core/tee.py).

The pretraining draws take a ``torch.Generator`` or an explicit index
array, so a test can hand the port the draws the reference made.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..optim import sgd_step
from .tee import Enclave

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    threshold: float = 0.7      # MNIST setting (CIFAR uses 0.3 in the paper)
    pretrain_steps: int = 300
    pretrain_lr: float = 0.1
    pretrain_batch: int = 64


def pretrain_clean_model(model, clean_x: torch.Tensor, clean_y: torch.Tensor,
                         cfg: FilterConfig,
                         generator: Optional[torch.Generator] = None, *,
                         idx: Optional[torch.Tensor] = None,
                         params: Optional[Params] = None,
                         device: DeviceLike = None) -> Params:
    """Train the screening model on the administrator's clean dataset:
    ``cfg.pretrain_steps`` plain SGD steps (no l2, no momentum) on
    minibatches of ``min(pretrain_batch, n)`` rows drawn with
    replacement.  The draws come from ``generator``, one step at a time,
    or are given as ``idx`` (steps, b).  The model starts from ``params``
    or from ``model.init(generator, device)``; it trains on ``device``
    (the card unless given)."""
    dev = resolve_device(device)
    x, y = clean_x.to(dev), clean_y.to(dev)
    n = int(y.shape[0])
    b = min(cfg.pretrain_batch, n)
    if idx is None and generator is None:
        raise ValueError("pretrain_clean_model needs a generator or idx")
    if idx is not None and tuple(idx.shape) != (cfg.pretrain_steps, b):
        raise ValueError(f"pretrain idx must be ({cfg.pretrain_steps}, {b}),"
                         f" got {tuple(idx.shape)}")
    if params is None:
        params = model.init(generator, dev)
    params = {k: v.to(dev) for k, v in params.items()}
    for i in range(cfg.pretrain_steps):
        if idx is None:
            rows = torch.randint(0, n, (b,), generator=generator,
                                 device=generator.device)
        else:
            rows = idx[i]
        rows = rows.to(dev)
        g = model.grad(params, (x[rows], y[rows]))
        params, _ = sgd_step(params, g, (), cfg.pretrain_lr)
    return params


def screen_clients(model, pretrained: Params, enclave: Enclave,
                   cfg: FilterConfig) -> Tuple[List[int], Dict[int, float]]:
    """Score every sealed client sample; returns (accepted ids, accs dict),
    both in ``enclave.client_ids()`` order.  Each sample is unsealed on
    the enclave's device and scored on the params' device.  Rejected
    clients are dropped from the enclave store (the paper's basic
    mitigation: drop, with offline human verification as the
    alternative)."""
    accepted, accs = [], {}
    for cid in list(enclave.client_ids()):
        x, y = enclave.unseal_samples(cid)
        acc = model.accuracy(pretrained, x, y)
        accs[cid] = acc
        if acc >= cfg.threshold:
            accepted.append(cid)
        else:
            enclave.drop_client(cid)
    return accepted, accs
