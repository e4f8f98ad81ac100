"""Coordinate-wise median and trimmed mean of client updates: the CUDA
kernel ``csrc/robust_agg.cu`` and its plain PyTorch version.

For (N, D) updates u and a Byzantine budget f both return ``(median (D,),
trimmed (D,))`` in fp32: the median averages the two middle values for
even N, and the trimmed mean is the mean of the values within the
(N - 2f)-th smallest distance to the median, ties admitted.  The CUDA
kernel replaces the TPU kernel ``src/repro/kernels/robust_agg.py``
``robust_agg_kernel`` and shares its limit of N <= 64 clients.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.aggregators import median
from . import _build

MAX_CLIENTS = 64            # the kernel stages one column in shared memory

# robust_agg_f32(u, med, trim, n, d, keep_n, stream) in csrc/robust_agg.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def keep_count(n: int, f: int) -> int:
    """How many distances to the median the trimmed mean admits."""
    if f < 0:
        raise ValueError(f"robust_aggregate: f must be >= 0, got {f}")
    return max(n - 2 * f, 1)


def robust_agg_plain(u: torch.Tensor, f: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the port's median (a sort along the client axis),
    then the threshold formulation of the reference's ``trimmed_ref``."""
    u = u.to(torch.float32)
    keep_n = keep_count(u.shape[0], f)
    med = median(u)
    dist = (u - med).abs()
    thresh = torch.sort(dist, dim=0).values[keep_n - 1]
    w = (dist <= thresh).to(torch.float32)
    return med, (u * w).sum(0) / w.sum(0).clamp_min(1.0)


def robust_agg_cuda(u: torch.Tensor, f: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: u (N, D) fp32
    contiguous on a CUDA device, 1 <= N <= 64 -> (median, trimmed), each
    (D,) fp32."""
    if u.dim() != 2:
        raise ValueError(f"robust_agg_cuda: u must be (N, D), got shape "
                         f"{tuple(u.shape)}")
    n, d = u.shape
    if not 1 <= n <= MAX_CLIENTS:
        raise ValueError(f"robust_agg_cuda: the kernel takes 1 to "
                         f"{MAX_CLIENTS} clients, got N = {n}")
    if not u.is_cuda:
        raise ValueError(f"robust_agg_cuda: u must be a CUDA tensor, got "
                         f"device {u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"robust_agg_cuda: u must be float32, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("robust_agg_cuda: u must be contiguous")
    keep_n = keep_count(n, f)
    med = torch.empty((d,), dtype=torch.float32, device=u.device)
    trim = torch.empty((d,), dtype=torch.float32, device=u.device)
    if d == 0:
        return med, trim
    fn = _build.entry_point("robust_agg", "robust_agg_f32", _ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = fn(u.data_ptr(), med.data_ptr(), trim.data_ptr(), n, d,
                  keep_n, stream)
    _build.check("robust_agg", code)
    robust_agg_cuda.launches += 1
    return med, trim


robust_agg_cuda.launches = 0
