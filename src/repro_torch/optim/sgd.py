"""SGD (optionally with momentum and weight decay) over dict params.

The arithmetic is in fp32 and each result is cast back to its
parameter's dtype, as the reference does; the state is fp32.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

Params = Dict[str, torch.Tensor]
State = Union[Tuple[()], Params]


def sgd_init(params: Params, momentum: float = 0.0) -> State:
    """``()`` without momentum, else fp32 zeros shaped like ``params``."""
    if momentum == 0.0:
        return ()
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd_step(params: Params, grads: Params, state: State, lr,
             momentum: float = 0.0, weight_decay: float = 0.0
             ) -> Tuple[Params, State]:
    """One step: ``g += weight_decay * p``; then ``p -= lr * g``, or with
    momentum ``m = momentum * m + g`` and ``p -= lr * m``."""
    if weight_decay:
        grads = {k: g + weight_decay * params[k].to(g.dtype)
                 for k, g in grads.items()}
    if momentum == 0.0:
        return {k: (p.to(torch.float32) - lr * grads[k].to(torch.float32))
                .to(p.dtype) for k, p in params.items()}, ()
    new_state = {k: momentum * m + grads[k].to(torch.float32)
                 for k, m in state.items()}
    return {k: (p.to(torch.float32) - lr * new_state[k]).to(p.dtype)
            for k, p in params.items()}, new_state


def apply_update(params: Params, update: Params, scale=1.0) -> Params:
    """theta <- theta - scale * update  (server-side Eq. 6 application)."""
    return {k: (p.to(torch.float32) - scale * update[k].to(torch.float32))
            .to(p.dtype) for k, p in params.items()}
