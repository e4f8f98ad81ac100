"""The int8 uplink's codec, plain PyTorch: symmetric per-block int8 with
per-client error feedback.

A flat float32 row ``x`` of width D is cut along its last axis into
blocks of ``QBLOCK`` (128) values, the last one zero-padded (zeros change
no block's absmax).  Each block's scale is its absmax divided by 127 in
a true division (the float32 quotient, correctly rounded); each value's
code is ``x / max(scale, 1e-30)``, again a true float32 division,
rounded half to even and clipped to [-127, 127].  An all-zero block has
scale 0 and codes 0.  The decode is ``code * scale`` in float32.

A client with the residual ``r`` sends ``enc(u + r)`` and keeps ``r' =
(u + r) - dec(enc(u + r))`` for its next round (:func:`feedback`).

The divisions are taken in float64 and rounded once to float32: the
double quotient of two floats rounds to the correctly rounded float32
quotient, so no division by a reciprocal's product enters.
"""
from __future__ import annotations

from typing import Tuple

import torch

QBLOCK = 128


def _blocks(x: torch.Tensor, qblock: int) -> torch.Tensor:
    """(..., D) -> (..., nb, qblock), the last block zero-padded."""
    d = x.shape[-1]
    nb = -(-d // qblock)
    out = x.new_zeros(tuple(x.shape[:-1]) + (nb * qblock,))
    out[..., :d] = x
    return out.reshape(tuple(x.shape[:-1]) + (nb, qblock))


def encode(x: torch.Tensor, qblock: int = QBLOCK
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (..., D) int8, scales (..., nb) float32) of float32 rows."""
    x = x.float()
    xb = _blocks(x, qblock)
    amax = xb.abs().amax(-1)
    scale = (amax.double() / 127.0).float()
    div = scale.clamp_min(1e-30).double().unsqueeze(-1)
    q = torch.round((xb.double() / div).float()).clamp(-127, 127)
    q = q.reshape(tuple(x.shape[:-1]) + (-1,))[..., :x.shape[-1]]
    return q.to(torch.int8), scale


def decode(q: torch.Tensor, scale: torch.Tensor,
           qblock: int = QBLOCK) -> torch.Tensor:
    """float32 rows ``code * scale``, (..., D)."""
    d = q.shape[-1]
    s = scale.float().repeat_interleave(qblock, dim=-1)[..., :d]
    return q.float() * s


def roundtrip(x: torch.Tensor, qblock: int = QBLOCK) -> torch.Tensor:
    """``dec(enc(x))``."""
    return decode(*encode(x, qblock), qblock)


def feedback(u: torch.Tensor, resid: torch.Tensor, qblock: int = QBLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(what the server decodes, the new residual) of a client's update
    row ``u`` with its residual ``resid``."""
    v = u.float() + resid
    dec = roundtrip(v, qblock)
    return dec, v - dec
