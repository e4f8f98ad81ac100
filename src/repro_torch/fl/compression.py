"""Update-stream codecs: the client→server wire format, in PyTorch.

A :class:`Codec` maps flat fp32 update rows ``(..., D)`` to an encoded
dict of tensors and back:

  - ``f32``: passthrough, lossless (the round skips error feedback).
  - ``bf16``: round-to-nearest-even bf16 payload, 2 bytes a parameter;
    bf16 → fp32 is exact, so the only error is the encode rounding.
  - ``int8``: symmetric per-block quantization, 1 byte a parameter plus
    one fp32 scale per ``QBLOCK`` parameters: ``q = round(x / scale)``
    with ``scale = absmax / 127`` per block of the last axis.

Encoded forms: ``{"q": payload}`` for f32/bf16 (``Codec.wire_dtype``
names the payload dtype; the weighted-fold kernel folds it directly) and
``{"q": int8, "scale": fp32}`` for int8 (``Codec.qblock`` set; the
dequantize-and-fold kernel folds it).  The streaming fold dispatches on
these two attributes (``fl/streaming.weighted_mean_rule``).

Lossy codecs carry per-client error feedback: a client sends
``enc(u + resid)`` and keeps ``resid' = (u + resid) - dec(enc(u +
resid))`` (:func:`encode_with_feedback`).  The int8 decode is
``kernels.dequant_fold.dequant_int8``, the port's one decode definition.

The encode keeps the reference's op sequence so that its bits are the
reference's: absmax over the block, a true division by 127 (a 0-d tensor
divisor: PyTorch turns a division by a Python scalar into a multiply by
its reciprocal on the card), the divisor clamped at 1e-30, round half to
even, clip to ±127, cast.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.dequant_fold import dequant_int8, n_blocks

QBLOCK = 128   # int8 quantization block width (params per fp32 scale)

Encoded = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire format for flat update rows.  ``encode`` maps ``(..., D)``
    fp32 to the encoded dict, ``decode`` inverts it to ``(..., D)`` fp32.
    ``lossless`` means decode∘encode is the identity (f32 only).
    ``wire_dtype`` is the dtype of ``enc["q"]`` when the weighted-fold
    kernel folds the payload as it is; ``qblock`` is set for the
    per-block-scaled codec that the dequantize-and-fold kernel folds."""
    name: str
    lossless: bool
    encode: Callable[[torch.Tensor], Encoded]
    decode: Callable[[Encoded], torch.Tensor]
    wire_dtype: Optional[torch.dtype] = None
    qblock: Optional[int] = None


_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> Codec:
    if codec.name in _CODECS:
        raise ValueError(f"codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _CODECS[name]
    except KeyError:
        raise ValueError(f"unknown compression codec {name!r}; "
                         f"available: {available_codecs()}") from None


def available_codecs() -> Tuple[str, ...]:
    """Registered codec names, in registration order."""
    return tuple(_CODECS)


# ----------------------------------------------------------------------
# Registered codecs
# ----------------------------------------------------------------------

def _f32_encode(x: torch.Tensor) -> Encoded:
    return {"q": x.to(torch.float32)}


def _f32_decode(enc: Encoded) -> torch.Tensor:
    return enc["q"]


def _bf16_encode(x: torch.Tensor) -> Encoded:
    return {"q": x.to(torch.bfloat16)}


def _bf16_decode(enc: Encoded) -> torch.Tensor:
    return enc["q"].to(torch.float32)


def _int8_encode(x: torch.Tensor, qblock: int = QBLOCK) -> Encoded:
    """Symmetric per-block int8.  The last axis is zero-padded to a
    ``qblock`` multiple (zeros cannot change a block's absmax), quantized
    blockwise and sliced back: ``q`` keeps the input's (..., D) shape,
    ``scale`` is (..., ⌈D/qblock⌉).  An all-zero block gets scale 0 and
    q 0, which decode to exactly 0."""
    x = x.to(torch.float32)
    d = x.shape[-1]
    nb = n_blocks(d, qblock)
    pad = nb * qblock - d
    xp = F.pad(x, (0, pad)) if pad else x
    xb = xp.reshape(tuple(xp.shape[:-1]) + (nb, qblock))
    scale = xb.abs().amax(-1) / torch.full((), 127.0, device=x.device)
    q = (xb / scale.clamp_min(1e-30).unsqueeze(-1)).round_()
    q = q.clamp_(-127, 127).to(torch.int8)
    q = q.reshape(xp.shape)[..., :d].contiguous()
    return {"q": q, "scale": scale}


def _int8_decode(enc: Encoded, qblock: int = QBLOCK) -> torch.Tensor:
    return dequant_int8(enc["q"], enc["scale"], qblock)


F32 = register_codec(Codec("f32", lossless=True, encode=_f32_encode,
                           decode=_f32_decode, wire_dtype=torch.float32))
BF16 = register_codec(Codec("bf16", lossless=False, encode=_bf16_encode,
                            decode=_bf16_decode, wire_dtype=torch.bfloat16))
INT8 = register_codec(Codec("int8", lossless=False, encode=_int8_encode,
                            decode=_int8_decode, qblock=QBLOCK))


# ----------------------------------------------------------------------
# Error feedback + guide-side quantization
# ----------------------------------------------------------------------

def encode_with_feedback(codec: Codec, u: torch.Tensor, resid: torch.Tensor):
    """The client boundary: transmit ``enc(u + resid)``, keep the error.
    Returns ``(enc, dec, new_resid)``: ``dec = decode(enc)`` is what the
    server folds and ``new_resid = (u + resid) - dec`` the error carried
    into the client's next round."""
    v = u.to(torch.float32) + resid
    enc = codec.encode(v)
    dec = codec.decode(enc)
    return enc, dec, v - dec


def quantize_tree(codec: Codec, tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Quantize-dequantize each (C, *shape) leaf of a client-batched params
    dict: the leaf flattens to (C, -1), so the codec's blocks run along
    each tensor on its own, and the decoded values take the leaf's shape
    again.  The enclave's guides go through it (no error feedback: they
    are recomputed from the sealed samples every round)."""
    if codec.lossless:
        return tree
    return {k: codec.decode(codec.encode(v.reshape(v.shape[0], -1)))
            .reshape(v.shape) for k, v in tree.items()}


def wire_bytes(codec: Codec, d: int) -> int:
    """Wire size of one client's encoded (d,) update: the bytes of the
    encoded tensors, from an encode on the meta device (nothing is
    allocated)."""
    enc = codec.encode(torch.empty((d,), dtype=torch.float32, device="meta"))
    return sum(t.numel() * t.element_size() for t in enc.values())
