"""Fine-grained Mixture-of-Experts with shared experts (DeepSeek-MoE
style).  The counterpart of ``repro/models/moe.py``.

Token dispatch is sort-based with a capacity limit (GShard-style
dropping), the reference's index inversion: the only scatters write small
int64/fp32 slot tables; token rows move by one gather into an (E, C, D)
block, and no (tokens x experts x capacity) one-hot is ever built.  The
expert products are batched matmuls over the leading expert dim.  The
reference's ``shard`` calls place that dim on the ``model`` mesh axis; on
one card they have no counterpart.

The combine adds each token's kept expert outputs in ascending slot order
(= ascending expert id), one add at a time in the output dtype, as
XLA:CPU's sequential scatter-add does; it uses no atomics, so a bf16
combine gives the same bits on every run.
"""
from __future__ import annotations

import torch

from ..sharding.api import (copy_to_model, reduce_from_model, shard,
                            tp_rank_count)
from .config import ModelConfig
from .layers import (activation, apply_mlp, dense_init, gated,
                     make_mlp_params, mlp_partial, mlp_split)


def make_moe_params(gen, cfg: ModelConfig, device, lead=()):
    """The router (D, E) in fp32; the routed experts' (E, D, F) and
    (E, F, D) weights in ``cfg.param_dtype`` (drawn one expert at a time,
    so no fp32 copy of a whole expert stack is held); the shared experts
    as one dense MLP of width ``n_shared_experts * d_expert``."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_expert
    pd, lead = cfg.param_dtype, tuple(lead)
    per_expert = lead + (E,)
    p = {"router": dense_init(gen, (D, E), torch.float32, device, lead=lead),
         "routed_up": dense_init(gen, (D, F), pd, device, fan_in=D,
                                 lead=per_expert),
         "routed_down": dense_init(gen, (F, D), pd, device, fan_in=F,
                                   lead=per_expert)}
    if gated(cfg.activation):
        p["routed_gate"] = dense_init(gen, (D, F), pd, device, fan_in=D,
                                      lead=per_expert)
    if cfg.n_shared_experts > 0:
        p["shared"] = make_mlp_params(
            gen, cfg, device, d_ff=cfg.n_shared_experts * cfg.d_expert,
            lead=lead)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """(probs (t, E) fp32, normalised gates (t, k), expert ids (t, k)).
    The top k come from a stable descending sort, so ties go to the lower
    expert id, as ``jax.lax.top_k`` breaks them."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], idx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def apply_moe(x: torch.Tensor, p, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B, S, D), the load-balance aux loss, fp32)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    t = B * S
    dev = x.device
    xf = x.reshape(t, D)
    probs, gates, idx = _route(xf, p["router"], K)

    # ---- load-balance auxiliary loss (Switch/GShard form) ----
    ones = torch.zeros((t, E), dtype=probs.dtype, device=dev).scatter_(
        1, idx, 1.0)
    aux = cfg.router_aux_coef * E * torch.sum(ones.mean(0) * probs.mean(0))

    # ---- sort-based dispatch with capacity dropping ----
    C = _capacity(t, cfg)
    eids = idx.reshape(-1)                                    # (t*K,)
    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    # bincount would read its largest id on the host to size its output
    counts = torch.zeros((E,), dtype=torch.int64, device=dev).scatter_add_(
        0, eids, torch.ones_like(eids))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * K, device=dev) - starts[sorted_eids]
    keep = pos < C
    dest = torch.where(keep, sorted_eids * C + pos.clamp(0, C - 1), E * C)
    tok = torch.div(order, K, rounding_mode="floor")          # source token

    # slot tables: slot -> source token, slot -> gate; every dropped
    # assignment writes the sentinel slot E*C, which is never read
    slot_tok = torch.full((E * C + 1,), t, dtype=torch.int64, device=dev)
    slot_tok[dest] = tok
    slot_gate = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev)
    slot_gate[dest] = keep * gates.reshape(-1)[order]

    # this rank's experts [e0, e0 + El): all E without an expert split
    El = p["routed_up"].shape[-3]
    split = El != E
    e0 = tp_rank_count()[0] * El if split else 0
    xe = copy_to_model(xf) if split else xf
    xf_pad = torch.cat([xe, xe.new_zeros((1, D))], dim=0)
    h = xf_pad[slot_tok[e0 * C:(e0 + El) * C]].reshape(El, C, D)  # gather
    h = shard(h, ("model", None, None))

    up = torch.bmm(h, p["routed_up"])
    if "routed_gate" in p:
        hidden = activation(torch.bmm(h, p["routed_gate"]),
                            cfg.activation) * up
    else:
        hidden = activation(up, cfg.activation)
    y = shard(torch.bmm(hidden, p["routed_down"]), ("model", None, None))

    # the gates enter the split too: each rank's gradient is its slots'
    gate = copy_to_model(slot_gate) if split else slot_gate
    contrib = y.reshape(El * C, D) * \
        gate[e0 * C:(e0 + El) * C, None].to(y.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((1, D))], dim=0)
    # each token's slots, ascending (a dropped one, or another rank's,
    # is the zero row El*C)
    slot_of = torch.empty_like(dest)
    slot_of[order] = dest
    slots = torch.sort(slot_of.reshape(t, K), dim=1).values - e0 * C
    slots = torch.where((slots >= 0) & (slots < El * C), slots, El * C)
    out = contrib[slots[:, 0]]
    for j in range(1, K):
        out = out + contrib[slots[:, j]]

    F_s = cfg.n_shared_experts * cfg.d_expert
    shared_split = "shared" in p and split and mlp_split(F_s, p["shared"])
    if shared_split:
        out = out + mlp_partial(xe, p["shared"], cfg)
    if split:
        out = reduce_from_model(out)
    if "shared" in p and not shared_split:
        out = out + apply_mlp(xf, p["shared"], cfg, d_ff=F_s)
    return out.reshape(B, S, D), aux
