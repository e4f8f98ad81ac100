"""DiverseFL — the paper's contribution (Sec. III), in PyTorch.

For every participating client j the enclave computes a guiding update
Δ̃_j by running the client's E local SGD steps on the small sample the
client shared once before training.  The client's uploaded update z_j is
kept iff both similarity conditions hold:

    C1 = sign(Δ̃_j · z_j)            C1 > ε1            (direction, Eq. 2/4)
    C2 = ‖z_j‖₂ / ‖Δ̃_j‖₂            ε2 < C2 < ε3        (length,   Eq. 3/5)

and the global model moves by the mean of the kept updates (Eq. 6).
Paper defaults: (ε1, ε2, ε3) = (0, 0.5, 2).

This module is the port's single definition of the criterion, the
statistics and Eq. 6; ``kernels/`` holds the CUDA kernels that compute
the statistics and the masked mean on the card, and uses the functions
here as their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiverseFLConfig:
    eps1: float = 0.0     # direction threshold: require dot > eps1 (sign test)
    eps2: float = 0.5     # length ratio lower bound
    eps3: float = 2.0     # length ratio upper bound


# ----------------------------------------------------------------------
# Similarity statistics and the C1/C2 criterion
# ----------------------------------------------------------------------

def similarity_stats(z: torch.Tensor, g: torch.Tensor):
    """Flat-vector stats: (z·g, ‖z‖², ‖g‖²) in fp32."""
    z = z.to(torch.float32).reshape(-1)
    g = g.to(torch.float32).reshape(-1)
    return torch.dot(z, g), torch.dot(z, z), torch.dot(g, g)


def _tree_vdot(a: Params, b: Params, per_row: bool = False) -> torch.Tensor:
    """Per-leaf fp32 products, each leaf reduced to a scalar (or, with
    ``per_row``, to one sum per row of its leading axis), then summed over
    the leaves in sorted key order, the order of the reference's pytree
    leaves."""
    parts = [a[k].to(torch.float32) * b[k].to(torch.float32)
             for k in sorted(a)]
    parts = [p.reshape(p.shape[0], -1).sum(1) if per_row else p.sum()
             for p in parts]
    return torch.stack(parts).sum(0)


def similarity_stats_tree(z_tree: Params, g_tree: Params):
    """Dict-params stats: (z·g, ‖z‖², ‖g‖²), fp32 per-leaf partials."""
    return (_tree_vdot(z_tree, g_tree), _tree_vdot(z_tree, z_tree),
            _tree_vdot(g_tree, g_tree))


def similarity_stats_matrix(U: torch.Tensor, G: torch.Tensor):
    """Stacked-matrix stats: U, G (N, D) -> per-client (z·g, ‖z‖², ‖g‖²).
    The plain version of the similarity kernel."""
    U = U.to(torch.float32)
    G = G.to(torch.float32)
    return (U * G).sum(1), (U * U).sum(1), (G * G).sum(1)


def diversefl_mask(dot, z_sq, g_sq, cfg: DiverseFLConfig) -> torch.Tensor:
    """Boolean keep-mask from per-client stats (elementwise).

    C1: kept iff dot > eps1.  C2: eps2 < ‖z‖/‖Δ̃‖ < eps3, evaluated in
    squared form to avoid the square root of tiny values."""
    c1 = dot > cfg.eps1
    ratio_sq = z_sq / g_sq.clamp_min(1e-30)
    c2 = (ratio_sq > cfg.eps2 ** 2) & (ratio_sq < cfg.eps3 ** 2)
    return c1 & c2


def c2_ratio(z_sq, g_sq) -> torch.Tensor:
    """C2 = ‖z‖/‖Δ̃‖ from the squared norms (Eq. 3/5)."""
    return torch.sqrt(z_sq / g_sq.clamp_min(1e-30))


def criterion_logs(dot, z_sq, g_sq) -> Dict[str, torch.Tensor]:
    """Per-client diagnostics: C1 = sign(Δ̃·z), C2 = ‖z‖/‖Δ̃‖ and their
    product (Fig. 2's y-axis)."""
    c1 = torch.sign(dot)
    c2 = c2_ratio(z_sq, g_sq)
    return {"c1": c1, "c2": c2, "c1c2": c1 * c2}


# ----------------------------------------------------------------------
# Guiding update (enclave Step 3)
# ----------------------------------------------------------------------

def sgd_round_once(t: torch.Tensor, lr, g: torch.Tensor) -> torch.Tensor:
    """One SGD step ``t - lr * g`` computed in fp32 and rounded once to
    ``t``'s dtype, as the reference's ``(t - lr * g).astype(t.dtype)`` with
    its fp32 rate does.  PyTorch would keep a bf16 ``lr * g`` in bf16 and
    round twice; for fp32 params this is the same arithmetic.

    The difference ``θ - θ_E`` of a bf16 run is taken in fp32 (exact for
    most pairs) and never rounded to bf16: the reference writes it in the
    params' dtype and casts it to fp32, and XLA fuses the two into one
    fp32 subtraction, so that is what the reference computes."""
    return (t.float() - lr * g.float()).to(t.dtype)


def write_update_rows(out: torch.Tensor, params: Params, batches,
                      grad_fn: Callable, lr, l2: float = 0.0, *,
                      clients: int, row0: int = 0,
                      rows: Optional[int] = None) -> torch.Tensor:
    """E = ``len(batches)`` local SGD steps of ``clients`` clients from the
    start ``params`` θ0, and their update rows θ0 - θ_E written once into
    rows ``row0 ..`` of the fp32 matrix ``out``, columns in the layout of
    ``core.aggregators.flatten_updates``.  Every leaf of ``params`` splits
    into ``clients`` rows along its leading axis (params every client
    shares are a zero-stride ``expand``, nothing copied); ``rows`` (default
    all) is how many of them are written, so a padded block writes only
    its real clients.

    ``grad_fn(θ, batch)`` is the gradient of the data loss alone, in the
    params' dtype; the ridge ``0.5·l2·Σ‖p‖²`` enters the step itself as
    ``l2·θ``, its exact gradient.  Each step is θ ← round(θ - lr·(g +
    l2·θ)), computed in fp32 and rounded once to the params' dtype
    (:func:`sgd_round_once`).  The last step and the difference run as one
    pass, ``kernels.ops.client_step_rows``: the CUDA kernel on the card.
    Returns ``out``."""
    from ..kernels import ops as kops     # ops imports this module
    keys = sorted(params)
    theta = params
    for batch in batches[:-1]:
        g = grad_fn(theta, batch)
        theta = {k: sgd_round_once(
            theta[k], lr, g[k].float() + l2 * theta[k].float() if l2
            else g[k]) for k in keys}
    g = grad_fn(theta, batches[-1])

    def split(t):
        return t.reshape(clients, -1)
    return kops.client_step_rows(
        out, [split(g[k]) for k in keys], [split(params[k]) for k in keys],
        [split(theta[k]) for k in keys], lr, l2, row0, rows)


def guiding_update(params: Params, guide_batch, grad_fn: Callable, lr,
                   E: int = 1, l2: float = 0.0) -> Params:
    """Δ̃ = θ - SGD_E(θ; M⁰): E gradient-descent steps on the enclave
    sample, mirroring the client's local optimizer (plain SGD, same lr,
    same E) per Algorithm 1.  ``grad_fn(params, batch) -> grads``; with
    client-batched params (leading client axis) and a matching batch the
    guides of all clients come out of one call.  ``l2`` is a ridge term
    that ``grad_fn`` leaves out (:func:`write_update_rows`, which computes
    the steps: one row of all the params).  Returns fp32 leaves of the
    params' shapes."""
    keys = sorted(params)
    sizes = [params[k].numel() for k in keys]
    dev = params[keys[0]].device
    out = torch.empty((1, sum(sizes)), dtype=torch.float32, device=dev)
    write_update_rows(out, params, [guide_batch] * E, grad_fn, lr, l2,
                      clients=1)
    parts = dict(zip(keys, out[0].split(sizes)))
    return {k: parts[k].reshape(params[k].shape) for k in params}


# ----------------------------------------------------------------------
# Aggregation (Eq. 6)
# ----------------------------------------------------------------------

def masked_sum_fold(U: torch.Tensor, w: torch.Tensor,
                    acc: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ordered weighted sum over the client axis: a strict left fold,
    client 0 first, one ``s + u_i * w_i`` per client, starting from
    ``acc`` (default zeros; never modified).  Fixing the association
    makes Eq. 6's bits independent of how the client axis is executed;
    the CUDA masked-mean kernel walks the clients in the same order.
    Returns ``(sum (D,), total weight)`` in fp32."""
    U = U.to(torch.float32)
    w = w.to(torch.float32)
    s = acc.to(torch.float32) if acc is not None else \
        torch.zeros(U.shape[1:], dtype=torch.float32, device=U.device)
    n = torch.zeros((), dtype=torch.float32, device=U.device)
    for i in range(U.shape[0]):
        s = s + U[i] * w[i]
        n = n + w[i]
    return s, n


def masked_mean_flat(U: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stacked-matrix Eq. 6: U (N, D), mask (N,) -> (D,) fp32 masked mean;
    an empty mask gives the zero update.  Reduces via
    :func:`masked_sum_fold`; the plain version of the masked-mean kernel."""
    s, n = masked_sum_fold(U, mask)
    return s / n.clamp_min(1.0)


def masked_mean(updates: Params, mask: torch.Tensor) -> Params:
    """updates: dict params with a leading client axis N; mask: (N,) bool
    or float.  The reference's ``(u * m).sum(0) / max(Σm, 1)`` per leaf,
    not the left fold, so it agrees with Eq. 6 to fp32 tolerance."""
    m = mask.to(torch.float32)
    denom = m.sum().clamp_min(1.0)
    return {k: (u.to(torch.float32) * m.reshape((-1,) + (1,) * (u.dim() - 1))
                ).sum(0) / denom for k, u in updates.items()}


def diversefl_aggregate(updates: Params, guides: Params,
                        cfg: DiverseFLConfig):
    """Steps 4 and 5 over dict params whose leaves have a leading client
    axis N.  Returns (aggregated update, keep mask (N,), stats dict with
    ``dot``, ``z_norm_sq``, ``g_norm_sq`` and ``c2``)."""
    dot = _tree_vdot(updates, guides, per_row=True)
    zz = _tree_vdot(updates, updates, per_row=True)
    gg = _tree_vdot(guides, guides, per_row=True)
    mask = diversefl_mask(dot, zz, gg, cfg)
    return masked_mean(updates, mask), mask, {
        "dot": dot, "z_norm_sq": zz, "g_norm_sq": gg, "c2": c2_ratio(zz, gg)}
