"""Causal GQA flash attention with an optional sliding window and tanh
softcap: the CUDA kernel ``csrc/flash_attention.cu`` and its plain
PyTorch version.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py`` ``flash_attention_kernel``.  It
is bound by its fp32 operations (4·dh per (query, key) pair inside the
mask); its design note is at the head of the ``.cu`` file.  The model
reaches it through ``ops.flash_attention`` for every attention layer of a
prefill longer than ``cfg.attn_direct_max`` when ``cfg.use_kernels``.

Layout: q (B, H, Sq, dh), k and v (B, K, Sk, dh), query head h reading KV
head h // (H / K), positions 0..Sq-1 and 0..Sk-1.  The kernel reads every
tensor through its strides (unit stride along dh), so callers pass
transposed views of the model's (B, S, H, dh) tensors without a copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -2.0 ** 30
PLAIN_Q_CHUNK = 512       # query rows per step of the plain version

# flash_attention_fwd(q, k, v, o, dtype, B, H, K, Sq, Sk, dh, 12 strides,
#                     scale, window, softcap, stream) in csrc/flash_attention.cu
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
             + (ctypes.c_int64,) * 12
             + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """The reference's ``flash_attention_ref`` formula: fp32 scores
    ``q·k / sqrt(dh)``, the softcap, the causal (and window) mask with the
    finite NEG_INF, softmax, ``p·v``; -> (B, H, Sq, dh) in q's dtype.
    Query rows go ``PLAIN_Q_CHUNK`` at a time (each row's softmax is its
    own), so the card can hold it at the model's shapes."""
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    g = H // K
    kf, vf = k.float(), v.float()
    kp = torch.arange(Sk, device=q.device)[None, :]
    out = torch.empty((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    for r0 in range(0, Sq, PLAIN_Q_CHUNK):
        r1 = min(r0 + PLAIN_Q_CHUNK, Sq)
        qf = q[:, :, r0:r1].reshape(B, K, g, r1 - r0, dh).float()
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) / math.sqrt(dh)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qp = torch.arange(r0, r1, device=q.device)[:, None]
        mask = kp <= qp
        if window is not None:
            mask &= kp > qp - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
        out[:, :, r0:r1] = o.reshape(B, H, r1 - r0, dh).to(q.dtype)
    return out


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"flash_attention_cuda: {name} must be a CUDA "
                         f"tensor, got device {t.device}")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"flash_attention_cuda: {name} must be "
                         f"{tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention_cuda: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention_cuda: {name} needs unit stride "
                         f"along dh, got strides {t.stride()}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: q (B, H, Sq, dh), k
    and v (B, K, Sk, dh), all fp32 or all bf16 on one card, any strides
    with a unit stride along dh; dh <= 256, H a multiple of K.  Writes
    (B, H, Sq, dh) in q's dtype into ``out`` (a new contiguous tensor if
    None; any strides with a unit stride along dh) and returns it."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_cuda: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_cuda: fp32 or bf16 only, got "
                        f"{q.dtype}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention_cuda: {H} query heads do not "
                         f"divide into {K} KV heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {dh} outside "
                         f"1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window must be >= 1, got "
                         f"{window}")
    _check(q, "q", (B, H, Sq, dh), q.dtype, q.device)
    _check(k, "k", (B, K, Sk, dh), q.dtype, q.device)
    _check(v, "v", (B, K, Sk, dh), q.dtype, q.device)
    if out is None:
        out = torch.empty((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    _check(out, "out", (B, H, Sq, dh), q.dtype, q.device)
    if B * H * Sq == 0:
        return out
    if Sk == 0:
        raise ValueError("flash_attention_cuda: no keys (Sk = 0)")
    fn = _build.entry_point("flash_attention", "flash_attention_fwd",
                            _ARGTYPES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  _DTYPE_CODE[q.dtype], B, H, K, Sq, Sk, dh, *strides,
                  1.0 / math.sqrt(dh), window or 0, float(softcap or 0.0),
                  stream)
    _build.check("flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
