"""Per-client similarity statistics (DiverseFL Step 4): the CUDA kernel
``csrc/similarity.cu`` and its plain PyTorch version.

For (N, D) updates z and guides g, both return the (N, 3) fp32 matrix
[z·g, ‖z‖², ‖g‖²] per client row.  The CUDA kernel replaces the TPU
kernel ``src/repro/kernels/similarity.py`` ``similarity_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.diversefl import similarity_stats_matrix
from . import _build

# similarity_stats_f32(z, g, out, n, d, stream) in csrc/similarity.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)


def similarity_plain(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the port's one definition of the statistics,
    :func:`~repro_torch.core.diversefl.similarity_stats_matrix` (three
    last-axis sums in fp32), stacked to the kernel's (N, 3) layout."""
    return torch.stack(similarity_stats_matrix(z, g), dim=-1)


def _check_operand(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"similarity_cuda: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"similarity_cuda: {name} must be float32, got "
                        f"{t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"similarity_cuda: {name} must be (N, D), got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"similarity_cuda: {name} must be contiguous")


def similarity_cuda(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: z, g (N, D) fp32
    contiguous CUDA tensors on one device -> (N, 3) fp32."""
    _check_operand("z", z)
    _check_operand("g", g)
    if z.shape != g.shape or z.device != g.device:
        raise ValueError(f"similarity_cuda: z {tuple(z.shape)} on {z.device} "
                         f"and g {tuple(g.shape)} on {g.device} must match")
    if (z.data_ptr() - g.data_ptr()) % 16:
        raise ValueError("similarity_cuda: z and g must share their 16-byte "
                         "alignment (the kernel's float4 loads read both "
                         "rows at the same offset)")
    n, d = z.shape
    out = torch.empty((n, 3), dtype=torch.float32, device=z.device)
    if n == 0:
        return out
    fn = _build.entry_point("similarity", "similarity_stats_f32", _ARGTYPES)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = fn(z.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, stream)
    _build.check("similarity", code)
    similarity_cuda.launches += 1
    return out


similarity_cuda.launches = 0
