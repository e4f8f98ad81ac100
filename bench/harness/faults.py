"""Faults planted under the timed path, to show that the comparison
rejects them: a round that leaves the params unchanged, a local step that
takes half of its batch (the mean over the rest), one client's Step 4
statistic altered where the kernel produces it, and, under a lossy
codec, the clients' error feedback dropped (each round encodes its
update with the residual zeroed).  (A cell on one chip has no exchange
between chips to leave out.)"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "answer", "no_feedback")


def kinds(traffic: dict) -> tuple:
    """The faults a cell of ``traffic`` can have: ``no_feedback`` only
    where its codec carries residuals."""
    return tuple(k for k in FAULTS
                 if k != "no_feedback" or traffic["compression"] != "f32")


class HalfBatch:
    """The program's model with every local step of more than one example
    cut to the first half of its batch."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def grad(self, params, batch, l2=0.0):
        x, y = batch
        m = x.shape[1]
        if m > 1:
            x, y = x[:, :m // 2], y[:, :m // 2]
        return self._inner.grad(params, (x, y), l2)


@contextlib.contextmanager
def planted(kind: str):
    """Patch the program's kernel operations (or, for ``no_feedback``,
    its client boundary) for ``kind`` while the ``with`` block runs
    (``half_batch`` wraps the model instead)."""
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops
    saved = {k: getattr(ops, k) for k in
             ("similarity_stats", "masked_aggregate", "masked_agg_update",
              "dequant_fold_update")}
    encode = simulator.encode_with_feedback
    if kind == "unchanged":
        ops.masked_aggregate = lambda u, mask: u.new_zeros(u.shape[1:])
        ops.masked_agg_update = lambda u, w, acc: acc.clone()
        ops.dequant_fold_update = lambda q, s, w, acc, qblock: acc.clone()
    elif kind == "no_feedback":
        simulator.encode_with_feedback = \
            lambda codec, u, resid: encode(codec, u, torch.zeros_like(resid))
    elif kind == "answer":
        def similarity_stats(z, g):
            out = saved["similarity_stats"](z, g).clone()
            out[0, 0] = -out[0, 0]
            return out
        ops.similarity_stats = similarity_stats
    elif kind not in ("half_batch", None):
        raise ValueError(f"fault {kind!r}; known: {FAULTS}")
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)
        simulator.encode_with_feedback = encode
