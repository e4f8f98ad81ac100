"""Masked mean of client updates (DiverseFL Step 5, Eq. 6): the CUDA
kernel ``csrc/masked_agg.cu`` and its plain PyTorch version.

For (N, D) updates u and an (N,) bool/float mask, both return the (D,)
fp32 mean of the masked rows; an empty mask gives the zero update.  The
kernel reads the mask as it is given, so Eq. 6 is one launch.  The
CUDA kernel replaces the TPU kernel ``src/repro/kernels/masked_agg.py``
``masked_agg_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.diversefl import masked_mean_flat
from . import _build

# masked_agg_f32(u, w, w_is_bool, acc, out, n, d, normalize, stream) in
# csrc/masked_agg.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p)

# The plain PyTorch version is the port's one definition of Eq. 6: the
# client-ordered left fold over max(Σm, 1), which the kernel walks in the
# same order.
masked_agg_plain = masked_mean_flat


def masked_agg_cuda(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: u (N, D) fp32
    contiguous, mask (N,) bool or float on the same CUDA device -> (D,)
    fp32 masked mean."""
    if not u.is_cuda:
        raise ValueError(f"masked_agg_cuda: u must be a CUDA tensor, got "
                         f"device {u.device}")
    if u.dtype != torch.float32:
        raise TypeError(f"masked_agg_cuda: u must be float32, got {u.dtype}")
    if u.dim() != 2:
        raise ValueError(f"masked_agg_cuda: u must be (N, D), got shape "
                         f"{tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError("masked_agg_cuda: u must be contiguous")
    n, d = u.shape
    if tuple(mask.shape) != (n,) or mask.device != u.device:
        raise ValueError(f"masked_agg_cuda: mask must be ({n},) on "
                         f"{u.device}, got {tuple(mask.shape)} on "
                         f"{mask.device}")
    if mask.dtype not in (torch.bool, torch.float32):
        raise TypeError(f"masked_agg_cuda: mask must be bool or float32, "
                        f"got {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError("masked_agg_cuda: mask must be contiguous")
    out = torch.empty((d,), dtype=torch.float32, device=u.device)
    if d == 0:
        return out
    fn = _build.entry_point("masked_agg", "masked_agg_f32", _ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        # the kernel reads the mask as it is; acc = NULL, normalize = 1:
        # the Eq. 6 mean
        code = fn(u.data_ptr(), mask.data_ptr(), int(mask.dtype == torch.bool),
                  None, out.data_ptr(), n, d, 1, stream)
    _build.check("masked_agg", code)
    masked_agg_cuda.launches += 1
    return out


masked_agg_cuda.launches = 0
