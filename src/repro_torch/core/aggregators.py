"""Byzantine-robust aggregation baselines the paper compares against
(Sec. IV + Appendix A), in PyTorch.  All operate on a stacked update
matrix ``U: (N, D)`` (clients × flattened model dim), fp32.

  - median      : coordinate-wise median [Yin et al., 9]
  - trimmed_mean: coordinate-wise trimmed mean (beta / closest-to-median)
  - krum        : update of the client closest to its N-f-2 neighbours [8]
  - bulyan      : recursive Krum selection + per-dim trimmed mean [12]
  - resampling  : s_R-fold resample-and-average then Median [24]
  - fltrust_weights: [26]'s trust scores and fold weights; FLTrust's one
    body is the registry rule in ``fl/server.py``, which folds them with
    the weighted-fold kernel

Medians come from a sort along the client axis, averaging the two middle
rows for even N as ``jnp.median`` does (``torch.median`` returns the lower
one, and ``torch.quantile`` refuses VGG-11's (23, 28.1M) matrix).  Every
tie-break is the reference's: stable argsorts, first-occurrence argmins.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch



def flatten_updates(updates: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Callable]:
    """Client-batched params dict (leading client dim N) -> (N, D) fp32
    matrix and an ``unravel((D,)) -> params`` function.  Leaves are laid
    out in sorted key order, the reference's pytree leaf order, so the
    columns line up with the reference's flat updates."""
    keys = sorted(updates)
    n = updates[keys[0]].shape[0]
    flat = torch.cat([updates[k].reshape(n, -1).to(torch.float32)
                      for k in keys], dim=1)
    shapes = [tuple(updates[k].shape[1:]) for k in keys]
    sizes = [math.prod(s) for s in shapes]

    def unravel(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, s, sz in zip(keys, shapes, sizes):
            out[k] = vec[off:off + sz].reshape(s)
            off += sz
        return out
    return flat, unravel


# ----------------------------------------------------------------------

def median(U: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median; the mean of the two middle values for even
    N, computed as ``(lo + hi) * 0.5`` like ``jnp.median``."""
    n = U.shape[0]
    s = torch.sort(U.to(torch.float32), dim=0).values
    h = n // 2
    return s[h] if n % 2 else (s[h - 1] + s[h]) * 0.5


def trimmed_mean(U: torch.Tensor, f: int, mode: str = "beta") -> torch.Tensor:
    """mode='beta': drop largest/smallest f per dim [9].
    mode='near_median': keep the N-2f values closest to the median per dim
    [12]; ties in distance keep the lower client index (stable sort)."""
    U = U.to(torch.float32)
    n = U.shape[0]
    if mode == "beta":
        s = torch.sort(U, dim=0).values
        kept = s[f:n - f] if n - 2 * f > 0 else s
        return kept.mean(0)
    d = (U - median(U)).abs()
    keep_n = max(n - 2 * f, 1)
    idx = torch.argsort(d, dim=0, stable=True)[:keep_n]       # (keep_n, D)
    return torch.gather(U, 0, idx).mean(0)


def _pairwise_sq_dists(U: torch.Tensor) -> torch.Tensor:
    sq = (U * U).sum(1)
    return sq[:, None] + sq[None, :] - 2.0 * (U @ U.T)


def _krum_scores_from_dists(d: torch.Tensor, f: int,
                            active: Optional[torch.Tensor]) -> torch.Tensor:
    n = d.shape[0]
    big = torch.tensor(1e30, dtype=d.dtype, device=d.device)
    d = d + torch.eye(n, dtype=d.dtype, device=d.device) * big  # no self
    if active is not None:
        d = torch.where(~active[None, :], big, d)
        n_active = active.sum()
    else:
        n_active = torch.tensor(n, device=d.device)
    k = torch.clamp(n_active - f - 2, 1, n - 1)
    # sum of the k smallest distances per row (k is dynamic under masking)
    cums = torch.cumsum(torch.sort(d, dim=1).values, dim=1)
    scores = cums[:, k - 1]
    if active is not None:
        scores = torch.where(active, scores, big)
    return scores


def krum_scores(U: torch.Tensor, f: int,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of distances to the nearest N-f-2 other clients (lower = better).

    ``active``: optional bool mask of clients still in play (Bulyan)."""
    U = U.to(torch.float32)
    return _krum_scores_from_dists(_pairwise_sq_dists(U), f, active)


def krum(U: torch.Tensor, f: int) -> torch.Tensor:
    return U[torch.argmin(krum_scores(U, f))].to(torch.float32)


def bulyan(U: torch.Tensor, f: int) -> torch.Tensor:
    """Recursive Krum to select N-2f candidates, then the [12] trimmed mean
    (per dim: mean of the N'-2f values closest to the median).  The
    pairwise distances are computed once; each of the n_sel Krum rounds
    masks out the clients already picked."""
    U = U.to(torch.float32)
    n = U.shape[0]
    n_sel = max(n - 2 * f, 1)
    d = _pairwise_sq_dists(U)
    active = torch.ones((n,), dtype=torch.bool, device=U.device)
    sel = []
    for _ in range(n_sel):
        j = torch.argmin(_krum_scores_from_dists(d, f, active))
        active[j] = False
        sel.append(j)
    V = U[torch.stack(sel)]                                   # (n_sel, D)
    f2 = max(min(f, (n_sel - 1) // 2), 0)
    if n_sel - 2 * f2 <= 0:
        f2 = max((n_sel - 1) // 2, 0)
    return trimmed_mean(V, f2, mode="near_median")


def resample_ids(n: int, s_r: int, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """[24]'s groups: s_r copies of every client id, shuffled, cut into n
    groups of s_r, so each client is used s_r times.  (n, s_r) int64."""
    dev = generator.device if generator is not None else device
    perm = torch.randperm(n * s_r, generator=generator, device=dev)
    return torch.arange(n, device=dev).repeat(s_r)[perm].reshape(n, s_r)


def resampling(U: torch.Tensor, s_r: int = 2, robust=median, *,
               generator: Optional[torch.Generator] = None,
               ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[24]: average N resampled groups of s_r clients, then ``robust``.
    The groups are drawn from ``generator`` or given as ``ids`` (N, s_r)."""
    n = U.shape[0]
    if ids is None:
        ids = resample_ids(n, s_r, generator, U.device)
    elif tuple(ids.shape) != (n, s_r):
        raise ValueError(f"resample ids must be ({n}, {s_r}), got "
                         f"{tuple(ids.shape)}")
    V = U.to(torch.float32)[ids.to(U.device)].mean(1)          # (N, D)
    return robust(V)


def fltrust_weights(U: torch.Tensor, root_update: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[26]'s trust scores TS_i = ReLU(cos(root, z_i)) and the fold weights
    a_i = TS_i · ‖root‖/‖z_i‖, which rescale each update to the root's
    length.  Both (N,) fp32."""
    r = root_update.to(torch.float32)
    Uf = U.to(torch.float32)
    rn = torch.linalg.vector_norm(r) + 1e-12
    un = torch.linalg.vector_norm(Uf, dim=1) + 1e-12
    ts = torch.relu((Uf @ r) / (un * rn))
    return ts, ts * (rn / un)

