"""Faults planted under the timed path, to show that the comparison
rejects them: a round that leaves the params unchanged, a local step that
takes half of its batch (the mean over the rest), and one client's Step 4
statistic altered where the kernel produces it.  (A cell on one chip has
no exchange between chips to leave out.)"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "answer")


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
    """Patch the program's kernel operations for ``kind`` while the
    ``with`` block runs (``half_batch`` wraps the model instead)."""
    from repro_torch.kernels import ops
    saved = {k: getattr(ops, k) for k in
             ("similarity_stats", "masked_aggregate", "masked_agg_update")}
    if kind == "unchanged":
        ops.masked_aggregate = lambda u, mask: u.new_zeros(u.shape[1:])
        ops.masked_agg_update = lambda u, w, acc: acc.clone()
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
