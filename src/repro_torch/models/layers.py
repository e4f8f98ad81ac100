"""Shared layer primitives of the zoo: norms, activations, MLPs,
initialisers.  The counterpart of ``repro/models/layers.py``.

Every ``make_*_params`` builds its leaves directly in ``cfg.param_dtype``
on ``device``, each with a leading ``lead`` shape (the stacked
``n_groups`` axis of the model's layout groups).  A stacked leaf is drawn
one lead index at a time in fp32 and cast into place, so no fp32 copy of
a whole stacked leaf is ever held: at falcon-mamba-7b's width that copy
would be 28 GB.  On the ``meta`` device nothing is drawn.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..sharding.api import (copy_to_model, reduce_from_model, shard,
                            tp_rank_count)
from .config import ModelConfig, torch_dtype


def _fill(out: torch.Tensor, lead: Sequence[int], draw) -> torch.Tensor:
    """Fill ``out`` (lead + shape) one lead index at a time with
    ``draw()`` (an fp32 tensor of the trailing shape), cast into place."""
    if out.device.type == "meta":
        return out
    flat = out.view(-1, *out.shape[len(lead):]) if lead else out[None]
    for i in range(flat.shape[0]):
        flat[i].copy_(draw())
    return out


def dense_init(gen: Optional[torch.Generator], shape, dtype, device,
               fan_in=None, lead=()) -> torch.Tensor:
    """N(0, 1/fan_in) in fp32, cast to ``dtype``.  ``fan_in`` defaults to
    ``shape[-2]`` (``shape[-1]`` for a vector), as in the reference."""
    shape = tuple(shape)
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(tuple(lead) + shape, dtype=torch_dtype(dtype),
                      device=device)
    return _fill(out, lead, lambda: torch.randn(
        shape, generator=gen, dtype=torch.float32, device=device) * scale)


def _const(value: float, shape, dtype, device, lead=()) -> torch.Tensor:
    return torch.full(tuple(lead) + tuple(shape), value,
                      dtype=torch_dtype(dtype), device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """Layer norm with the population variance."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def make_norm_params(gen, cfg: ModelConfig, device, d=None, lead=()):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": _const(1.0, (d,), cfg.param_dtype, device, lead),
                "bias": _const(0.0, (d,), cfg.param_dtype, device, lead)}
    # rmsnorm scales by (1 + scale)
    return {"scale": _const(0.0, (d,), cfg.param_dtype, device, lead)}


def apply_norm(x, p, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(x)
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def gated(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ----------------------------------------------------------------------
# Dense MLP (gated or plain)
# ----------------------------------------------------------------------

def make_mlp_params(gen, cfg: ModelConfig, device, d_ff=None, lead=()):
    d_ff = d_ff or cfg.d_ff
    pd = cfg.param_dtype
    p = {"w_up": dense_init(gen, (cfg.d_model, d_ff), pd, device, lead=lead),
         "w_down": dense_init(gen, (d_ff, cfg.d_model), pd, device,
                              lead=lead)}
    if gated(cfg.activation):
        p["w_gate"] = dense_init(gen, (cfg.d_model, d_ff), pd, device,
                                 lead=lead)
    return p


def mlp_split(d_ff: int, p) -> bool:
    """Whether the MLP of width ``d_ff`` runs split over the model group:
    a model axis > 1 that tiles ``d_ff``, ``w_down`` in ``p`` this rank's
    rows (and ``w_up``/``w_gate`` its columns)."""
    _, ms = tp_rank_count()
    return ms > 1 and d_ff % ms == 0 and p["w_down"].shape[-2] != d_ff


def mlp_partial(x, p, cfg: ModelConfig):
    """This rank's term of the MLP: column-parallel up (and gate), the
    activation on the rank's hidden units, row-parallel down.  ``x`` has
    entered the model-parallel region (:func:`copy_to_model`); the sum
    over the group (:func:`reduce_from_model`) is the MLP.  Whole leaves
    give the whole MLP."""
    up = shard(x @ p["w_up"], (None, None, "model"))
    if "w_gate" in p:
        h = activation(x @ p["w_gate"], cfg.activation) * up
    else:
        h = activation(up, cfg.activation)
    return h @ p["w_down"]


def apply_mlp(x, p, cfg: ModelConfig, d_ff=None):
    """The MLP of width ``d_ff`` (``cfg.d_ff`` unless given): split over
    the model group where :func:`mlp_split` says so (one ``all_reduce``
    forward, one backward), else whole on every rank."""
    if mlp_split(d_ff or cfg.d_ff, p):
        return reduce_from_model(mlp_partial(copy_to_model(x), p, cfg))
    return mlp_partial(x, p, cfg)
