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

def guiding_update(params: Params, guide_batch, grad_fn: Callable, lr,
                   E: int = 1) -> Params:
    """Δ̃ = θ - SGD_E(θ; M⁰): E gradient-descent steps on the enclave
    sample, mirroring the client's local optimizer (plain SGD, same lr,
    same E) per Algorithm 1.  ``grad_fn(params, batch) -> grads``; with
    client-batched params (leading client axis) and a matching batch the
    guides of all clients come out of one call."""
    theta = params
    for _ in range(E):
        g = grad_fn(theta, guide_batch)
        theta = {k: theta[k] - lr * g[k] for k in theta}
    return {k: (params[k] - theta[k]).to(torch.float32) for k in params}


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
