"""Adam / AdamW over param trees (centralized pre-training and non-FL
drivers; FL local steps use plain SGD, as in the paper).  The moments
are fp32 and each step is computed in fp32 and cast back once to its
parameter's dtype, as the reference does.
"""
from __future__ import annotations

from typing import Any

import torch

from ..convert import leaf_paths


def _map(fn, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (nested dicts, tuples and lists of tensors)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adam_init(params):
    """fp32 zero moments shaped like ``params`` and the step count 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = leaf_paths(params)[0][1].device
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_step(params, grads, state, lr, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0):
    """One Adam step (AdamW's decoupled decay with ``weight_decay``).
    -> (new params, new state)."""
    t = state["t"] + 1
    m = _map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
             state["m"], grads)
    v = _map(lambda v, g: b2 * v + (1 - b2) * torch.square(
        g.to(torch.float32)), state["v"], grads)
    tf = t.to(torch.float32)
    bc1 = 1 - b1 ** tf
    bc2 = 1 - b2 ** tf

    def upd(p, m, v):
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - step).to(p.dtype)
    return _map(upd, params, m, v), {"m": m, "v": v, "t": t}
