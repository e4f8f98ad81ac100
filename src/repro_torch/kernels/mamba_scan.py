"""Mamba-1 selective scan: the CUDA kernel ``csrc/mamba_scan.cu`` and its
plain PyTorch version.

For dA, dBx (B, S, di, n) and C (B, S, n), all fp32, from h = 0:
``h_t = dA_t · h_{t-1} + dBx_t`` and ``y_t = ⟨h_t, C_t⟩``; both versions
return ``(y (B, S, di), h_S (B, di, n))``.  The CUDA kernel replaces the
TPU kernel ``src/repro/kernels/mamba_scan.py`` ``mamba_scan_kernel``,
which returns y only: the port's prefill hands the final state to
decode.  The kernel is bound by HBM bytes (dA and dBx read once); its
design note is at the head of the ``.cu`` file.  It takes any S and di,
and the state sizes the zoo's configs use (``STATE_SIZES``), so the
reference's ``bs``/``bd`` fallback for shapes its tiles do not divide
(``repro/kernels/ops.py:113-114``) has no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

STATE_SIZES = (8, 16)     # n the kernel is built for: full and SMOKE

# mamba_scan_f32(da, dbx, c, y, h_last, B, S, di, n, stream) in
# csrc/mamba_scan.cu
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int64,) * 4
             + (ctypes.c_void_p,))


def mamba_scan_plain(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``mamba_scan_ref``: the sequential loop over t in
    fp32.  -> (y (B, S, di), final state (B, di, n))."""
    B, S, di, n = da.shape
    h = torch.zeros((B, di, n), dtype=torch.float32, device=da.device)
    y = torch.empty((B, S, di), dtype=torch.float32, device=da.device)
    da, dbx, c = da.float(), dbx.float(), c.float()
    for t in range(S):
        h = da[:, t] * h + dbx[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t])
    return y, h


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"mamba_scan_cuda: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"mamba_scan_cuda: {name} must be {tuple(shape)} on "
                         f"{device}, got {tuple(t.shape)} on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"mamba_scan_cuda: {name} must be float32, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"mamba_scan_cuda: {name} must be contiguous")


def mamba_scan_cuda(da: torch.Tensor, dbx: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: da, dbx (B, S, di, n)
    and c (B, S, n), fp32, contiguous, on one card, n in STATE_SIZES ->
    (y (B, S, di), final state (B, di, n)), new fp32 tensors."""
    if da.dim() != 4:
        raise ValueError(f"mamba_scan_cuda: da must be (B, S, di, n), got "
                         f"{tuple(da.shape)}")
    B, S, di, n = da.shape
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan_cuda: state size {n} is not one the "
                         f"kernel is built for, {STATE_SIZES}")
    _check(da, "da", (B, S, di, n), da.device)
    _check(dbx, "dbx", (B, S, di, n), da.device)
    _check(c, "c", (B, S, n), da.device)
    for name, t in (("da", da), ("dbx", dbx)):
        if t.data_ptr() % 16:
            raise ValueError(f"mamba_scan_cuda: {name} must be 16-byte "
                             f"aligned")
    y = torch.empty((B, S, di), dtype=torch.float32, device=da.device)
    h = torch.empty((B, di, n), dtype=torch.float32, device=da.device)
    if B * di == 0:
        return y, h
    fn = _build.entry_point("mamba_scan", "mamba_scan_f32", _ARGTYPES)
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        code = fn(da.data_ptr(), dbx.data_ptr(), c.data_ptr(), y.data_ptr(),
                  h.data_ptr(), B, S, di, n, stream)
    _build.check("mamba_scan", code)
    mamba_scan_cuda.launches += 1
    return y, h


mamba_scan_cuda.launches = 0
