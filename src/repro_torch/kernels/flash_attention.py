"""Causal GQA flash attention with an optional sliding window and tanh
softcap: the CUDA kernels ``csrc/flash_attention_bf16.cu`` (bf16) and
``csrc/flash_attention.cu`` (fp32) and their plain PyTorch version.

Both kernels replace the TPU kernel ``src/repro/kernels/flash_attention.py``
``flash_attention_kernel``.  Both are bound by their operations, 4·dh per
(query, key) pair inside the mask: the bf16 kernel runs both products on
the tensor cores (``mma.sync``, fp32 accumulation, 989 TFLOP/s peak), the
fp32 one as fp32 FMAs (67 TFLOP/s), since TF32 or bf16 operands would
round fp32 inputs.  Their design notes are at the heads of the ``.cu``
files.  The fp32 kernel's launch plan (its head-dim bucket, 16- or
4-byte copies, how many key chunks a q tile is split into where the grid
would not fill the card) is computed here by :func:`fp32_plan`, a pure
function of the shapes, strides and addresses.  The model reaches them
through ``ops.flash_attention`` for every attention layer of a prefill
longer than ``cfg.attn_direct_max`` when ``cfg.use_kernels``.

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
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

NEG_INF = -2.0 ** 30
PLAIN_Q_CHUNK = 512       # query rows per step of the plain version

# flash_attention_bf16_fwd (csrc/flash_attention_bf16.cu) and
# flash_attention_fwd_simt_v1 (csrc/flash_attention.cu, the pre-redesign
# fp32 kernel): (q, k, v, o, B, H, K, Sq, Sk, dh, 12 strides, scale, window,
# softcap, stream)
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
             + (ctypes.c_int64,) * 12
             + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p))
# flash_attention_fwd (csrc/flash_attention.cu, fp32): (q, k, v, o, ws_o,
# ws_ml, B, H, K, Sq, Sk, dh, 12 strides, scale, window, softcap, splits,
# vec16, stream)
_FP32_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                  + (ctypes.c_int64,) * 12
                  + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
MAX_HEAD_DIM = 256

# the fp32 kernel's tiling (csrc/flash_attention.cu): 64 query rows and
# 32-key tiles a block; head-dim buckets and the blocks of each that fit
# an SM (the kernel's launch bounds and shared memory)
FP32_Q_TILE = 64
FP32_KEY_TILE = 32
FP32_BUCKETS = (16, 32, 64, 80, 128, 256)
FP32_BLOCKS_PER_SM = (4, 4, 4, 4, 3, 1)
MAX_SPLITS = 8            # key chunks a q tile, at most
MIN_SPLIT_TILES = 4       # key tiles the heaviest chunk keeps, at least


class Fp32Plan(NamedTuple):
    bucket: int           # the padded head dim the kernel instantiates
    copy_bytes: int       # 16 (cp.async of 4 floats) or 4
    n_qt: int             # 64-row q tiles
    splits: int           # key chunks a q tile; 1: no combine pass
    blocks: int           # n_qt * H * B * splits


def fp32_key_tiles(qt: int, Sq: int, Sk: int,
                   window: Optional[int]) -> Tuple[int, int]:
    """[first, last] 32-key tile that q tile ``qt`` walks: from the first
    key its first row's window reaches to the causal frontier of its last
    row."""
    q0 = qt * FP32_Q_TILE
    last = min(min(q0 + FP32_Q_TILE, Sq) - 1, Sk - 1) // FP32_KEY_TILE
    first = max(0, q0 - window + 1) // FP32_KEY_TILE if window else 0
    return first, last


def fp32_split_range(first: int, last: int, split: int,
                     splits: int) -> Tuple[int, int]:
    """The tiles [lo, hi) of chunk ``split`` of a q tile's [first, last],
    as the kernel cuts them: contiguous, in order, sizes within one."""
    n = last - first + 1
    return first + n * split // splits, first + n * (split + 1) // splits


def fp32_block_item(block: int, n_qt: int, heads: int,
                    splits: int) -> Tuple[int, int, int]:
    """(q tile, batch * H + head, split) of a block, as the kernel decodes
    its index: the heaviest q tile first, the heads of one q tile
    together, a q tile's splits side by side."""
    item, split = divmod(block, splits)
    rest, hb = divmod(item, heads)
    return n_qt - 1 - rest, hb, split


def fp32_plan(B: int, H: int, Sq: int, Sk: int, dh: int,
              window: Optional[int], strides, addresses,
              n_sm: int) -> Fp32Plan:
    """The fp32 kernel's launch plan from the shapes, the (batch, head,
    sequence) element strides and the base addresses of q, k and v, and
    the card's SM count.  16-byte copies need dh % 4 == 0, 16-byte bases
    and strides in multiples of 4 floats.  Where the B H n_qt blocks would
    not fill the card's block slots twice over, each q tile's keys are cut
    into ``splits`` chunks, enough for one and a half waves (the best
    count at kernel_bench's shape on the H100, ``kernel_probe.py``), at
    most MAX_SPLITS, and never below MIN_SPLIT_TILES tiles for the
    heaviest q tile."""
    b = next(i for i, d in enumerate(FP32_BUCKETS) if dh <= d)
    vec = (dh % 4 == 0 and all(a % 16 == 0 for a in addresses)
           and all(st % 4 == 0 for st in strides))
    n_qt = -(-Sq // FP32_Q_TILE)
    items = B * H * n_qt
    slots = n_sm * FP32_BLOCKS_PER_SM[b]
    splits = 1
    if 2 * items <= slots:
        spans = (fp32_key_tiles(t, Sq, Sk, window) for t in range(n_qt))
        heaviest = max(last - first + 1 for first, last in spans)
        splits = max(1, min(-(-3 * slots // (2 * items)), MAX_SPLITS,
                            heaviest // MIN_SPLIT_TILES))
    return Fp32Plan(FP32_BUCKETS[b], 16 if vec else 4, n_qt, splits,
                    items * splits)


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


def _operands(q, k, v, window, out, name):
    """Check q, k, v (and ``out``, allocated when None) for a kernel:
    -> (B, H, K, Sq, Sk, dh, out)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: fp32 or bf16 only, got {q.dtype}")
    if K < 1 or H % K:
        raise ValueError(f"{name}: {H} query heads do not divide into {K} "
                         f"KV heads")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    _check(q, "q", (B, H, Sq, dh), q.dtype, q.device)
    _check(k, "k", (B, K, Sk, dh), q.dtype, q.device)
    _check(v, "v", (B, K, Sk, dh), q.dtype, q.device)
    if out is None:
        out = torch.empty((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    _check(out, "out", (B, H, Sq, dh), q.dtype, q.device)
    if B * H * Sq and Sk == 0:
        raise ValueError(f"{name}: no keys (Sk = 0)")
    return B, H, K, Sq, Sk, dh, out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: q (B, H, Sq, dh), k
    and v (B, K, Sk, dh), all fp32 or all bf16 on one card, any strides
    with a unit stride along dh; dh <= 256, H a multiple of K.  Writes
    (B, H, Sq, dh) in q's dtype into ``out`` (a new contiguous tensor if
    None; any strides with a unit stride along dh) and returns it."""
    B, H, K, Sq, Sk, dh, out = _operands(q, k, v, window, out,
                                         "flash_attention_cuda")
    if B * H * Sq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    scale = 1.0 / math.sqrt(dh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            check_bf16_operands(q, k, v, out)
            lib = "flash_attention_bf16"
            fn = _build.entry_point(lib, "flash_attention_bf16_fwd",
                                    _ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, H, K, Sq, Sk, dh, *strides, scale,
                      window or 0, float(softcap or 0.0), stream)
        else:
            plan = fp32_plan(B, H, Sq, Sk, dh, window, strides[:9],
                             [t.data_ptr() for t in (q, k, v)],
                             _sm_count(q.device.index))
            ws_o = ws_ml = None
            if plan.splits > 1:
                rows = plan.splits * B * H * Sq
                ws_o = torch.empty((rows, dh), dtype=torch.float32,
                                   device=q.device)
                ws_ml = torch.empty((rows, 2), dtype=torch.float32,
                                    device=q.device)
            lib = "flash_attention"
            fn = _build.entry_point(lib, "flash_attention_fwd",
                                    _FP32_ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(),
                      None if ws_o is None else ws_o.data_ptr(),
                      None if ws_ml is None else ws_ml.data_ptr(),
                      B, H, K, Sq, Sk, dh, *strides, scale, window or 0,
                      float(softcap or 0.0), plan.splits,
                      int(plan.copy_bytes == 16), stream)
    _build.check(lib, code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_simt_v1_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None
                                 ) -> torch.Tensor:
    """The fp32 kernel as it was before its redesign for the H100 (the
    first SIMT kernel), same arguments and result for fp32 inputs.  No path
    calls it: the on-card check holds it to the plain version and times
    it beside :func:`flash_attention_cuda`."""
    B, H, K, Sq, Sk, dh, out = _operands(q, k, v, window, None,
                                         "flash_attention_simt_v1_cuda")
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_simt_v1_cuda: fp32 only, got "
                        f"{q.dtype}")
    if B * H * Sq == 0:
        return out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    fn = _build.entry_point("flash_attention", "flash_attention_fwd_simt_v1",
                            _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, K, Sq, Sk, dh, *strides, 1.0 / math.sqrt(dh),
                  window or 0, float(softcap or 0.0), stream)
    _build.check("flash_attention", code)
    return out
