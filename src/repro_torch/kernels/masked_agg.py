"""Masked mean and weighted fold of client updates: the CUDA kernel
``csrc/masked_agg.cu`` and its plain PyTorch versions.

* Eq. 6 (DiverseFL Step 5): for (N, D) updates u and an (N,) bool/float
  mask, the (D,) fp32 mean of the masked rows; an empty mask gives the
  zero update.  The kernel reads the mask as it is given, so Eq. 6 is one
  launch.  Replaces the TPU kernel ``src/repro/kernels/masked_agg.py``
  ``masked_agg_kernel``.
* The weighted fold ``acc + Σᵢ wᵢuᵢ`` with fp32 weights: FLTrust's
  aggregation, and the streaming fold of an fp32 or bf16 client block
  (the bf16 payload is widened in the kernel, exactly).  Same kernel,
  with the accumulator and no normalisation.  Replaces the TPU kernel
  ``masked_agg_update_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.diversefl import masked_mean_flat, masked_sum_fold
from . import _build

# masked_agg_fold(u, u_is_bf16, w, w_is_bool, acc, out, n, d, normalize,
# stream) in csrc/masked_agg.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p)

# The plain PyTorch version is the port's one definition of Eq. 6: the
# client-ordered left fold over max(Σm, 1), which the kernel walks in the
# same order.
masked_agg_plain = masked_mean_flat


def masked_agg_update_plain(u: torch.Tensor, w: torch.Tensor,
                            acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the weighted fold: the client-ordered left fold
    ``s = acc; s = s + uᵢ·wᵢ`` for i = 0 .. n-1, in fp32 (a bf16 ``u`` is
    widened to fp32 first, exactly).  The kernel walks
    the clients in the same order but fuses each step into one ``fmaf``,
    so with weights whose products round the two differ by rounding; with
    0/1 weights they are bitwise equal."""
    return masked_sum_fold(u, w, acc)[0]


def _check_u(fn: str, u: torch.Tensor, dtypes=(torch.float32,)) -> None:
    if not u.is_cuda:
        raise ValueError(f"{fn}: u must be a CUDA tensor, got device "
                         f"{u.device}")
    if u.dtype not in dtypes:
        raise TypeError(f"{fn}: u must be one of {dtypes}, got {u.dtype}")
    if u.dim() != 2:
        raise ValueError(f"{fn}: u must be (N, D), got shape "
                         f"{tuple(u.shape)}")
    if not u.is_contiguous():
        raise ValueError(f"{fn}: u must be contiguous")


def _check_vector(fn: str, name: str, t: torch.Tensor, size: int,
                  device: torch.device, dtypes) -> None:
    if tuple(t.shape) != (size,) or t.device != device:
        raise ValueError(f"{fn}: {name} must be ({size},) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} must be one of {dtypes}, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _launch(u, w, acc, out, normalize: int) -> None:
    n, d = u.shape
    fn = _build.entry_point("masked_agg", "masked_agg_fold", _ARGTYPES)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        code = fn(u.data_ptr(), int(u.dtype == torch.bfloat16), w.data_ptr(),
                  int(w.dtype == torch.bool),
                  None if acc is None else acc.data_ptr(), out.data_ptr(),
                  n, d, normalize, stream)
    _build.check("masked_agg", code)


def masked_agg_cuda(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: u (N, D) fp32
    contiguous, mask (N,) bool or float on the same CUDA device -> (D,)
    fp32 masked mean."""
    _check_u("masked_agg_cuda", u)
    n, d = u.shape
    _check_vector("masked_agg_cuda", "mask", mask, n, u.device,
                  (torch.bool, torch.float32))
    out = torch.empty((d,), dtype=torch.float32, device=u.device)
    if d == 0:
        return out
    # acc = NULL, normalize = 1: the Eq. 6 mean
    _launch(u, mask, None, out, 1)
    masked_agg_cuda.launches += 1
    return out


def masked_agg_update_cuda(u: torch.Tensor, w: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: u (n, D) fp32 or
    bf16, w (n,) and acc (D,) fp32, all contiguous, on one CUDA device ->
    a new (D,) fp32 tensor ``acc + Σᵢ wᵢuᵢ``.  Unlike the reference, which
    donates acc, the port does not update acc in place: the kernel's
    output may not alias its inputs."""
    _check_u("masked_agg_update_cuda", u, (torch.float32, torch.bfloat16))
    n, d = u.shape
    _check_vector("masked_agg_update_cuda", "w", w, n, u.device,
                  (torch.float32,))
    _check_vector("masked_agg_update_cuda", "acc", acc, d, u.device,
                  (torch.float32,))
    out = torch.empty((d,), dtype=torch.float32, device=u.device)
    if d == 0:
        return out
    # normalize = 0: the un-normalised fold from acc
    _launch(u, w, acc, out, 0)
    masked_agg_update_cuda.launches += 1
    return out


masked_agg_cuda.launches = 0
masked_agg_update_cuda.launches = 0
