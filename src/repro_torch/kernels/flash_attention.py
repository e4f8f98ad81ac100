"""Causal GQA flash attention with an optional sliding window and tanh
softcap: the CUDA kernels ``csrc/flash_attention_bf16.cu`` (bf16) and
``csrc/flash_attention.cu`` (fp32) and their plain PyTorch version.

Both kernels replace the TPU kernel ``src/repro/kernels/flash_attention.py``
``flash_attention_kernel``.  Both are bound by their operations, 4·dh per
(query, key) pair inside the mask: the bf16 kernel runs both products on
the tensor cores (``mma.sync``, fp32 accumulation, 989 TFLOP/s peak), the
fp32 one as fp32 FMAs (67 TFLOP/s), since TF32 or bf16 operands would
round fp32 inputs.  Their design notes are at the heads of the ``.cu``
files.  The model reaches them through ``ops.flash_attention`` for every
attention layer of a prefill longer than ``cfg.attn_direct_max`` when
``cfg.use_kernels``.

The bf16 kernel's tensor cores take bf16 operands, so it splits p into
bf16(p) and the bf16 of the remainder and runs p·v twice into the same
fp32 accumulators: p enters with about 16 bits, near the plain version's
fp32 p·v.  The card holds it to one bf16 step of the plain version (atol
1e-5, rtol 2⁻⁷), and its mask to the exact probe of
:func:`mask_probe_inputs`.

Layout: q (B, H, Sq, dh), k and v (B, K, Sk, dh), query head h reading KV
head h // (H / K), positions 0..Sq-1 and 0..Sk-1.  The kernels read every
tensor through its strides (unit stride along dh), so callers pass
transposed views of the model's (B, S, H, dh) tensors without a copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

NEG_INF = -2.0 ** 30
PLAIN_Q_CHUNK = 512       # query rows per step of the plain version

# flash_attention_fwd (csrc/flash_attention.cu, fp32) and
# flash_attention_bf16_fwd (csrc/flash_attention_bf16.cu): (q, k, v, o, B,
# H, K, Sq, Sk, dh, 12 strides, scale, window, softcap, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
             + (ctypes.c_int64,) * 12
             + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p))
# dtype -> (library, entry point)
_ENTRY = {torch.float32: ("flash_attention", "flash_attention_fwd"),
          torch.bfloat16: ("flash_attention_bf16",
                           "flash_attention_bf16_fwd")}
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


def mask_probe_inputs(B: int, H: int, K: int, S: int, dh: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """q, k, v that make attention count its admitted keys exactly: q = 0,
    so every admitted key scores 0 (and tanh(0) = 0 under a softcap), p = 1
    exactly in bf16 and l is the number of admitted keys; k and v have a 1
    in column j mod dh of row j and zeros elsewhere.  Output column c of a
    row is then (its admitted keys j with j = c mod dh) / l: one key wrongly
    admitted or dropped at a window edge or a diagonal moves a column by
    about 1/(l/dh) of itself, which a bar of 2^-7 sees up to l ~ 128 dh."""
    q = torch.zeros((B, H, S, dh), dtype=dtype, device=device)
    j = torch.arange(S, device=device)
    v = torch.zeros((B, K, S, dh), dtype=dtype, device=device)
    v[:, :, j, j % dh] = 1.0
    return q, v.clone(), v


def check_bf16_operands(*tensors: torch.Tensor) -> None:
    """The bf16 kernel's layout, checked before any launch: dh a multiple
    of 8, a 16-byte-aligned base and (batch, head, sequence) strides that
    are multiples of 8 elements, so every row starts on 16 bytes, as
    ``cp.async`` needs.  Raises ValueError naming the tensor; there is no
    fallback."""
    for name, t in zip("qkvo", tensors):
        dh = t.shape[-1]
        if dh % 8:
            raise ValueError(f"flash_attention_cuda: bf16 needs a head dim "
                             f"that is a multiple of 8, got {dh}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: bf16 {name} must start "
                             f"on 16 bytes, got address {t.data_ptr():#x}")
        if any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention_cuda: bf16 {name} needs "
                             f"strides that are multiples of 8, got "
                             f"{t.stride()}")


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
    if q.dtype not in _ENTRY:
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
    if q.dtype == torch.bfloat16:
        check_bf16_operands(q, k, v, out)
    lib, symbol = _ENTRY[q.dtype]
    fn = _build.entry_point(lib, symbol, _ARGTYPES)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, K, Sq, Sk, dh, *strides, 1.0 / math.sqrt(dh),
                  window or 0, float(softcap or 0.0), stream)
    _build.check(lib, code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
