"""Public kernel operations of the port.

A CUDA tensor goes to the hand-written CUDA kernel; a CPU tensor goes to
the kernel's plain PyTorch version.  Nothing here catches a build or
launch error, and a tensor on any other device raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.diversefl import DiverseFLConfig, diversefl_mask
from .dequant_fold import dequant_fold_update_cuda, dequant_fold_update_plain
from .masked_agg import (masked_agg_cuda, masked_agg_plain,
                         masked_agg_update_cuda, masked_agg_update_plain)
from .robust_agg import robust_agg_cuda, robust_agg_plain
from .similarity import similarity_cuda, similarity_plain

# the launching wrappers, by the kernel name chip_smoke.py reports
KERNELS = {"similarity_stats": similarity_cuda,
           "masked_aggregate": masked_agg_cuda,
           "masked_agg_update": masked_agg_update_cuda,
           "robust_aggregate": robust_agg_cuda,
           "dequant_fold_update": dequant_fold_update_cuda}


def _route(t: torch.Tensor, name: str) -> bool:
    """True -> launch the CUDA kernel, False -> the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device} (CUDA tensors "
                     f"go to the kernel, CPU tensors to the plain version)")


def similarity_stats(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, D) x (N, D) -> (N, 3) fp32 [z·g, ‖z‖², ‖g‖²] per client."""
    if _route(z, "similarity_stats"):
        return similarity_cuda(z, g)
    return similarity_plain(z, g)


def masked_aggregate(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) -> (D,) masked mean (Eq. 6); empty mask -> zeros."""
    if _route(u, "masked_aggregate"):
        return masked_agg_cuda(u, mask)
    return masked_agg_plain(u, mask)


def masked_agg_update(u: torch.Tensor, w: torch.Tensor,
                      acc: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 or bf16, (n,), (D,) -> a new (D,) ``acc + Σᵢ wᵢuᵢ``
    (fp32 weights, no normalisation; acc is not modified)."""
    if _route(u, "masked_agg_update"):
        return masked_agg_update_cuda(u, w, acc)
    return masked_agg_update_plain(u, w, acc)


def dequant_fold_update(q: torch.Tensor, scale: torch.Tensor,
                        w: torch.Tensor, acc: torch.Tensor,
                        qblock: int) -> torch.Tensor:
    """int8 (n, D), fp32 (n, ⌈D/qblock⌉), (n,), (D,) -> a new (D,)
    ``acc + Σᵢ wᵢ·(qᵢ ⊙ scaleᵢ)``: the int8 uplink's fold, decode fused
    (acc is not modified)."""
    if _route(q, "dequant_fold_update"):
        return dequant_fold_update_cuda(q, scale, w, acc, qblock)
    return dequant_fold_update_plain(q, scale, w, acc, qblock)


def robust_aggregate(u: torch.Tensor, f: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) -> (median (D,), trimmed mean (D,)): the coordinate-wise
    median and the mean of the values within the (N-2f)-th smallest
    distance to it.  The CUDA route takes N <= 64."""
    if _route(u, "robust_aggregate"):
        return robust_agg_cuda(u, f)
    return robust_agg_plain(u, f)


def diversefl_step45(u: torch.Tensor, g: torch.Tensor, cfg: DiverseFLConfig):
    """DiverseFL Steps 4 and 5: (N, D) updates and guides -> (delta (D,),
    keep mask (N,), (z·g, ‖z‖², ‖g‖²)).  One kernel pass over u and g for
    the statistics, the C1/C2 mask on (N,) scalars, one pass over u for
    the masked mean."""
    stats = similarity_stats(u, g)
    dot, zz, gg = stats.unbind(1)
    mask = diversefl_mask(dot, zz, gg, cfg)
    return masked_aggregate(u, mask), mask, (dot, zz, gg)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
