"""Paper-scale models (Sec. IV) in PyTorch; this slice has softmax
regression.

A model is functional, like the reference's: ``init(generator, device)
-> params`` (a dict of tensors), ``apply(params, x) -> logits``.  Params
keep the reference's layout — ``w`` is (input_dim, n_classes) — and may
carry a leading client axis: with ``w`` (C, input_dim, n_classes) and
``x`` (C, m, ...), ``apply`` and ``loss`` evaluate C independent models at
once, which is how the port runs every client's local SGD in one batched
pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

from ..device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SmallModel:
    name: str
    init: Callable                     # (generator, device) -> params
    apply: Callable                    # (params, x) -> logits
    input_shape: tuple
    n_classes: int

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor,
             l2: float = 0.0) -> torch.Tensor:
        """Mean cross-entropy plus ``0.5 * l2 * Σ‖p‖²``.  Scalar for plain
        params; one loss per client, shape (C,), for client-batched ones."""
        logits = self.apply(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, y.unsqueeze(-1)).squeeze(-1).mean(-1)
        if l2:
            nb = nll.dim()                 # 0 plain, 1 client-batched
            nll = nll + 0.5 * l2 * sum(
                (p * p).flatten(nb).sum(-1) for p in params.values())
        return nll

    def grad(self, params: Params, batch, l2: float = 0.0) -> Params:
        """Gradient of :meth:`loss` for every parameter.  With
        client-batched params the per-client losses are summed before the
        backward pass: clients share no parameter, so each client's slice
        of the gradient is its own loss's gradient."""
        x, y = batch
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total = self.loss(leaves, x, y, l2).sum()
            grads = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, grads))


def _glorot(generator: torch.Generator, shape, device) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    fan_out = shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2 * lim) - lim).to(device)


def softmax_regression(input_dim: int = 784, n_classes: int = 10,
                       zero_init: bool = True) -> SmallModel:
    def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        w = torch.zeros((input_dim, n_classes), device=dev) if zero_init \
            else _glorot(generator, (input_dim, n_classes), dev)
        return {"w": w, "b": torch.zeros((n_classes,), device=dev)}

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        w, b = params["w"], params["b"]
        lead = w.dim() - 1                 # (m,) plain, (C, m) batched
        h = x.reshape(tuple(x.shape[:lead]) + (-1,))
        return h @ w + b.unsqueeze(-2)
    return SmallModel("softmax_regression", init, apply,
                      (input_dim,), n_classes)
