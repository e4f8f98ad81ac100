"""Fused dequantize-and-fold of an int8 client block: the CUDA kernel
``csrc/dequant_fold.cu`` and its plain PyTorch version.

The int8 uplink (``fl/compression.py``) sends each client's update as an
int8 payload ``q`` (n, D) and one fp32 scale per ``qblock`` columns,
``scale`` (n, ⌈D/qblock⌉).  The streaming fold accumulates
``acc + Σᵢ wᵢ·(qᵢ ⊙ scaleᵢ)`` over a client block, reading one byte per
element instead of the four of a decoded block.  The CUDA kernel replaces
the TPU kernel ``src/repro/kernels/dequant_fold.py``
``dequant_fold_update_kernel``.

:func:`dequant_int8` is the port's one decode definition: the int8
codec's ``decode``, the dense lossy path and the kernel's plain version
all go through it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.diversefl import masked_sum_fold
from . import _build

# dequant_fold_f32(q, scale, w, acc, out, n, d, nb, qblock, stream) in
# csrc/dequant_fold.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)


def n_blocks(d: int, qblock: int) -> int:
    """Scale blocks of a row of ``d`` columns: ⌈d / qblock⌉."""
    return -(-d // qblock)


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 qblock: int) -> torch.Tensor:
    """Per-block symmetric int8 decode: ``q`` (..., d) int8 and ``scale``
    (..., ⌈d/qblock⌉) fp32 -> (..., d) fp32 with column c equal to the
    exactly rounded product ``q[..., c] · scale[..., c // qblock]``, the
    reference's ``dequant_int8_ref``.  The last block may be partial.
    The products are taken in place in the one (..., d) output."""
    d = q.shape[-1]
    nb = n_blocks(d, qblock)
    if scale.shape[-1] != nb:
        raise ValueError(f"dequant_int8: scale must have {nb} blocks for "
                         f"d = {d}, qblock = {qblock}; got "
                         f"{tuple(scale.shape)}")
    out = q.to(torch.float32, copy=True)
    s = scale.to(torch.float32).unsqueeze(-1)
    full = d // qblock
    if full:
        out[..., :full * qblock].unflatten(-1, (full, qblock)).mul_(
            s[..., :full, :])
    if full < nb:
        out[..., full * qblock:].mul_(s[..., full, :])
    return out


def dequant_fold_update_plain(q: torch.Tensor, scale: torch.Tensor,
                              w: torch.Tensor, acc: torch.Tensor,
                              qblock: int) -> torch.Tensor:
    """Plain version: decode, then the client-ordered left fold
    ``s = acc; s = s + decᵢ·wᵢ``.  The kernel walks the clients in the
    same order with one ``fmaf`` a step, so with 0/1 weights the two are
    bitwise equal; with real weights they differ by rounding."""
    return masked_sum_fold(dequant_int8(q, scale, qblock), w, acc)[0]


def _check(name: str, t: torch.Tensor, shape, dtype,
           device: torch.device) -> None:
    """Shape and device match, then dtype; each refusal names the
    tensor."""
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"dequant_fold_update_cuda: {name} must be "
                         f"{tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"dequant_fold_update_cuda: {name} must be {dtype}, "
                        f"got {t.dtype}")


def _check_placement(name: str, t: torch.Tensor) -> None:
    """A contiguous CUDA tensor; the refusal names the tensor."""
    if not t.is_cuda:
        raise ValueError(f"dequant_fold_update_cuda: {name} must be a CUDA "
                         f"tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"dequant_fold_update_cuda: {name} must be "
                         f"contiguous")


def _launch(symbol: str, q: torch.Tensor, scale: torch.Tensor,
            w: torch.Tensor, acc: torch.Tensor, qblock: int) -> torch.Tensor:
    """Check the operands, allocate the output and launch entry point
    ``symbol`` of ``csrc/dequant_fold.cu`` on the current stream."""
    if q.dim() != 2:
        raise ValueError(f"dequant_fold_update_cuda: q must be (n, D), got "
                         f"shape {tuple(q.shape)}")
    if qblock < 1:
        raise ValueError(f"dequant_fold_update_cuda: qblock must be >= 1, "
                         f"got {qblock}")
    n, d = q.shape
    nb = n_blocks(d, qblock)
    operands = {"q": (q, (n, d), torch.int8),
                "scale": (scale, (n, nb), torch.float32),
                "w": (w, (n,), torch.float32),
                "acc": (acc, (d,), torch.float32)}
    for name, (t, shape, dtype) in operands.items():
        _check(name, t, shape, dtype, q.device)
    for name, (t, _, _) in operands.items():
        _check_placement(name, t)
    out = torch.empty((d,), dtype=torch.float32, device=q.device)
    if d == 0:
        return out
    fn = _build.entry_point("dequant_fold", symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), scale.data_ptr(), w.data_ptr(),
                  acc.data_ptr(), out.data_ptr(), n, d, nb, qblock, stream)
    _build.check("dequant_fold", code)
    return out


def dequant_fold_update_cuda(q: torch.Tensor, scale: torch.Tensor,
                             w: torch.Tensor, acc: torch.Tensor,
                             qblock: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: q (n, D) int8, scale
    (n, ⌈D/qblock⌉), w (n,) and acc (D,) fp32, all contiguous on one CUDA
    device -> a new (D,) fp32 tensor ``acc + Σᵢ wᵢ·(qᵢ ⊙ scaleᵢ)``.  The
    reference donates acc; the port writes a new tensor, since the
    kernel's output may not alias its inputs."""
    out = _launch("dequant_fold_f32", q, scale, w, acc, qblock)
    if q.shape[1]:
        dequant_fold_update_cuda.launches += 1
    return out


dequant_fold_update_cuda.launches = 0


def dequant_fold_update_percolumn_cuda(q: torch.Tensor, scale: torch.Tensor,
                                       w: torch.Tensor, acc: torch.Tensor,
                                       qblock: int) -> torch.Tensor:
    """The kernel as it was before its redesign for the H100 (one thread a
    column, one byte load a client), same arguments and result.  No path
    calls it: the on-card check holds :func:`dequant_fold_update_cuda` to
    it bit for bit with real weights, and times the two side by side."""
    return _launch("dequant_fold_percolumn_f32", q, scale, w, acc, qblock)
