"""Coordinate-wise median and trimmed mean of client updates: the CUDA
kernel ``csrc/robust_agg.cu`` and its plain PyTorch version.

For (N, D) updates u and a Byzantine budget f both return ``(median (D,),
trimmed (D,))`` in fp32: the median averages the two middle values for
even N, and the trimmed mean is the mean of the values within the
(N - 2f)-th smallest distance to the median, ties admitted.  The CUDA
kernel replaces the TPU kernel ``src/repro/kernels/robust_agg.py``
``robust_agg_kernel`` and shares its limit of N <= 64 clients.  It sorts
each column in registers with the network of :func:`network_pairs` for the
padded size :func:`sort_bucket` (the same comparators the ``.cu`` builds
at compile time), then reads the trimmed mean's threshold off the sorted
column as the narrowest window of N - 2f values around the median.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..core.aggregators import median
from . import _build

MAX_CLIENTS = 64            # the TPU kernel's limit
SORT_BUCKETS = (8, 16, 24, 32, 48, 64)   # a column's padded length

# robust_agg_f32_v1(u, med, trim, n, d, keep_n, stream) and
# robust_agg_f32(..., keep_n, blocks, stream) in csrc/robust_agg.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)
_GRID_ARGTYPES = _ARGTYPES[:6] + (ctypes.c_int, ctypes.c_void_p)


def sort_bucket(n: int) -> int:
    """The padded column length the kernel sorts for N clients."""
    return next(p for p in SORT_BUCKETS if n <= p)


def network_pairs(n: int) -> Tuple[Tuple[int, int], ...]:
    """Batcher's odd-even merge sort for n elements as the kernel unrolls
    it (``make_net`` in csrc/robust_agg.cu): compare-swap (a, b), a < b,
    the minimum to a, in this order."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k - 1, n - j - k - 1) + 1):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


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


def _launch(symbol: str, u: torch.Tensor, f: int, blocks=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check u and launch ``symbol``; ``blocks`` (the grid; 0 lets the
    kernel choose) goes to the entry point that takes one, None to the
    one that does not."""
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
    grid = () if blocks is None else (blocks,)
    fn = _build.entry_point("robust_agg", symbol,
                            _ARGTYPES if blocks is None else _GRID_ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = fn(u.data_ptr(), med.data_ptr(), trim.data_ptr(), n, d,
                  keep_n, *grid, stream)
    _build.check("robust_agg", code)
    return med, trim


def robust_agg_cuda(u: torch.Tensor, f: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: u (N, D) fp32
    contiguous on a CUDA device, 1 <= N <= 64 -> (median, trimmed), each
    (D,) fp32."""
    out = _launch("robust_agg_f32", u, f, 0)
    if u.shape[1]:
        robust_agg_cuda.launches += 1
    return out


robust_agg_cuda.launches = 0


def robust_agg_v1_cuda(u: torch.Tensor, f: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel as it was before its redesign for the H100 (the column
    sorted twice in shared memory), same arguments and result.  No
    path calls it: the on-card check holds :func:`robust_agg_cuda`'s
    median to it bit for bit and times the two side by side."""
    return _launch("robust_agg_f32_v1", u, f)
