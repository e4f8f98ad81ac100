"""The reference's matrix products, at float32 or at a lower precision.

``Precision("fp32")`` multiplies in float32 (TF32 is off: the harness sets
``torch.backends.cuda.matmul.allow_tf32 = False``).  The lower modes are
the controls that the comparison has to reject:

* ``"tf32"``: every operand of every product, forward and backward,
  rounded to TF32's 10-bit mantissa (round to nearest even), then
  multiplied with float32 accumulation, which is what the tensor cores do
  with TF32 on;
* ``"fp8"``: every operand scaled by its own amax to e4m3's range, cast
  to ``float8_e4m3fn`` and back (per-tensor scaling, as fp8 training
  recipes do), then multiplied with float32 accumulation.

The rounding is emulated, so a mode gives the same numbers on the CPU and
on the card.
"""
from __future__ import annotations

import torch

MODES = ("fp32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties to even."""
    x = x.contiguous().float()
    i = x.view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 -> e4m3 with a per-tensor scale, back in float32."""
    x = x.float()
    s = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


class _Low(torch.autograd.Function):
    """``a @ b`` with every operand rounded, forward and backward."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        qa, qb = rnd(a), rnd(b)
        ctx.save_for_backward(qa, qb)
        ctx.rnd = rnd
        return qa @ qb

    @staticmethod
    def backward(ctx, go):
        qa, qb = ctx.saved_tensors
        g = ctx.rnd(go)
        return g @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ g, None


class Precision:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r}; known: {MODES}")
        self.mode = mode
        self._rnd = {"tf32": round_tf32, "fp8": round_fp8}.get(mode)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (batched as ``torch.matmul``) in this precision."""
        if self._rnd is None:
            return a @ b
        if b.dim() == 2 and a.dim() > 2:
            out = _Low.apply(a.reshape(-1, a.shape[-1]), b, self._rnd)
            return out.reshape(a.shape[:-1] + (b.shape[-1],))
        return _Low.apply(a, b, self._rnd)
