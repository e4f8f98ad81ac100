"""Public kernel operations of the port.

A CUDA tensor goes to the hand-written CUDA kernel; a CPU tensor goes to
the kernel's plain PyTorch version.  Nothing here catches a build or
launch error, and a tensor on any other device raises.  No kernel has a
backward (nor has the reference's): a CUDA call under grad on an operand
that requires grad raises by name instead of returning an output that
autograd would silently treat as a constant.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.diversefl import DiverseFLConfig, diversefl_mask
from .client_step import client_step_rows_cuda, client_step_rows_plain
from .dequant_fold import dequant_fold_update_cuda, dequant_fold_update_plain
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .mamba_scan import mamba_scan_cuda, mamba_scan_plain
from .masked_agg import (masked_agg_cuda, masked_agg_plain,
                         masked_agg_update_cuda, masked_agg_update_plain)
from .robust_agg import robust_agg_cuda, robust_agg_plain
from .similarity import similarity_cuda, similarity_plain

# the launching wrappers, by the kernel name chip_smoke.py reports
KERNELS = {"similarity_stats": similarity_cuda,
           "masked_aggregate": masked_agg_cuda,
           "masked_agg_update": masked_agg_update_cuda,
           "robust_aggregate": robust_agg_cuda,
           "dequant_fold_update": dequant_fold_update_cuda,
           "flash_attention": flash_attention_cuda,
           "mamba_scan": mamba_scan_cuda,
           "client_step_rows": client_step_rows_cuda}


def _route(t: torch.Tensor, name: str, *operands: torch.Tensor) -> bool:
    """True -> launch the CUDA kernel, False -> the plain version.  ``t``
    and ``operands`` are the call's tensors.  The gradient check reads
    host-side flags only, so it never syncs and stays legal under CUDA
    graph capture."""
    if t.is_cuda:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (t,) + operands):
            raise ValueError(
                f"{name}: the CUDA kernel has no backward, and an operand "
                f"requires grad under torch.enable_grad(); its output would "
                f"carry no gradient.  Run the kernel under torch.no_grad() "
                f"on detached tensors, or take the plain path "
                f"(cfg.use_kernels=False) for training")
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device} (CUDA tensors "
                     f"go to the kernel, CPU tensors to the plain version)")


def similarity_stats(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(N, D) x (N, D) -> (N, 3) fp32 [z·g, ‖z‖², ‖g‖²] per client."""
    if _route(z, "similarity_stats", g):
        return similarity_cuda(z, g)
    return similarity_plain(z, g)


def masked_aggregate(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, D), (N,) -> (D,) masked mean (Eq. 6); empty mask -> zeros."""
    if _route(u, "masked_aggregate", mask):
        return masked_agg_cuda(u, mask)
    return masked_agg_plain(u, mask)


def masked_agg_update(u: torch.Tensor, w: torch.Tensor,
                      acc: torch.Tensor) -> torch.Tensor:
    """(n, D) fp32 or bf16, (n,), (D,) -> a new (D,) ``acc + Σᵢ wᵢuᵢ``
    (fp32 weights, no normalisation; acc is not modified)."""
    if _route(u, "masked_agg_update", w, acc):
        return masked_agg_update_cuda(u, w, acc)
    return masked_agg_update_plain(u, w, acc)


def dequant_fold_update(q: torch.Tensor, scale: torch.Tensor,
                        w: torch.Tensor, acc: torch.Tensor,
                        qblock: int) -> torch.Tensor:
    """int8 (n, D), fp32 (n, ⌈D/qblock⌉), (n,), (D,) -> a new (D,)
    ``acc + Σᵢ wᵢ·(qᵢ ⊙ scaleᵢ)``: the int8 uplink's fold, decode fused
    (acc is not modified)."""
    if _route(q, "dequant_fold_update", scale, w, acc):
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


def diversefl_step45(u: torch.Tensor, g: Optional[torch.Tensor],
                     cfg: DiverseFLConfig,
                     stats: Optional[torch.Tensor] = None):
    """DiverseFL Steps 4 and 5: (N, D) updates and guides -> (delta (D,),
    keep mask (N,), (z·g, ‖z‖², ‖g‖²)).  One kernel pass over u and g for
    the statistics, the C1/C2 mask on (N,) scalars, one pass over u for
    the masked mean.  ``stats`` (N, 3), where given, are the statistics
    already computed (by the data ranks of a split round, each from its
    own rows), and ``g`` is not read."""
    if stats is None:
        stats = similarity_stats(u, g)
    dot, zz, gg = stats.unbind(1)
    mask = diversefl_mask(dot, zz, gg, cfg)
    return masked_aggregate(u, mask), mask, (dot, zz, gg)


def client_step_rows(out: torch.Tensor, grads, theta0, thetap, lr,
                     l2: float = 0.0, row0: int = 0,
                     rows: Optional[int] = None) -> torch.Tensor:
    """One local SGD step's update rows of c clients, written once into
    rows ``row0 ..`` of the fp32 matrix ``out`` (``kernels/client_step``):
    leaf lists of (c, ...) gradients, start params θ0 and step params θp
    (a zero-stride client axis for shared params) -> ``out``.  The CUDA
    kernel takes fp32 or bf16 params and refuses any other type."""
    if _route(out, "client_step_rows", *grads, *theta0, *thetap):
        return client_step_rows_cuda(out, grads, theta0, thetap, lr, l2,
                                     row0, rows)
    return client_step_rows_plain(out, grads, theta0, thetap, lr, l2, row0,
                                  rows)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,Sq,dh), k/v (B,K,Sk,dh) -> (B,H,Sq,dh) causal GQA attention
    with an optional sliding window and tanh softcap, written into
    ``out`` when given (any strides, unit stride along dh)."""
    if _route(q, "flash_attention", k, v):
        return flash_attention_cuda(q, k, v, window, softcap, out=out)
    o = flash_attention_plain(q, k, v, window, softcap)
    return o if out is None else out.copy_(o)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Model-layout adapter: q (B,S,H,dh), k/v (B,S,K,dh) -> (B,S,H,dh).
    The kernel reads and writes the model's layout through strides: the
    transposes here are views, nothing is copied."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window, softcap,
                         out=out.transpose(1, 2))
    return out


def mamba_scan_raw(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dA, dBx (B,S,di,n), C (B,S,n) fp32 -> (y (B,S,di), final state
    (B,di,n)) of h_t = dA_t·h_{t-1} + dBx_t, y_t = <h_t, C_t>."""
    if _route(da, "mamba_scan", dbx, c):
        return mamba_scan_cuda(da, dbx, c)
    return mamba_scan_plain(da, dbx, c)


def mamba_scan(xc: torch.Tensor, p, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model adapter: post-conv activations (B,S,di) -> (scan output
    (B,S,di) fp32, final state (B,di,n) fp32).  The reference's adapter
    returns the output only; the port's prefill also hands the state to
    decode."""
    from ..models.mamba import _ssm_coeffs
    da, dbx, c = _ssm_coeffs(xc, p, cfg)
    return mamba_scan_raw(da, dbx, c)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
