"""Flat update layout shared by the server and the round body.

The robust aggregation baselines of the reference module (median,
trimmed mean, Krum, Bulyan, resampling, FLTrust) are not ported yet; this
slice needs only the (N, D) layout of client updates.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch


def flatten_updates(updates: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Callable]:
    """Client-batched params dict (leading client dim N) -> (N, D) fp32
    matrix and an ``unravel((D,)) -> params`` function.  Leaves are laid
    out in sorted key order, the reference's pytree leaf order, so the
    columns line up with the reference's flat updates."""
    keys = sorted(updates)
    n = updates[keys[0]].shape[0]
    flat = torch.cat([updates[k].reshape(n, -1).to(torch.float32)
                      for k in keys], dim=1)
    shapes = [tuple(updates[k].shape[1:]) for k in keys]
    sizes = [math.prod(s) for s in shapes]

    def unravel(vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, s, sz in zip(keys, shapes, sizes):
            out[k] = vec[off:off + sz].reshape(s)
            off += sz
        return out
    return flat, unravel
