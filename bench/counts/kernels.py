"""The chip's peaks and each FL kernel's least time, from shapes.

A kernel's least time is the larger of its bytes over the HBM bandwidth
and its operations over the peak of its type, counting each input byte
read once and each output byte written once (the arithmetic of
``chip_smoke.py``'s ``bound_ms``).  ``calls`` lists the launches a round
of a traffic mix makes, with their shapes.
"""
from __future__ import annotations

import math

from bench.reference.int8 import QBLOCK

# NVIDIA H100 SXM data sheet, dense rates
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

_SIZE = {"float32": 4, "bfloat16": 2, "bool": 1}


def least_s(bytes_: float, ops: float, dtype: str = "float32") -> float:
    return max(bytes_ / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def similarity_stats(rows: int, d: int, dtype: str = "float32") -> tuple:
    """(N, D) x (N, D) -> (N, 3): (bytes, ops)."""
    return 2 * rows * d * _SIZE[dtype] + rows * 3 * 4, 6 * rows * d


def masked_aggregate(rows: int, d: int, dtype: str = "float32") -> tuple:
    """(N, D) updates, an (N,) bool mask -> the (D,) mean."""
    return rows * d * _SIZE[dtype] + rows + d * 4, 2 * rows * d


def masked_agg_update(rows: int, d: int, dtype: str = "float32") -> tuple:
    """(n, D) updates, (n,) fp32 weights, the (D,) accumulator -> a new
    (D,) accumulator."""
    return rows * d * _SIZE[dtype] + rows * 4 + 2 * d * 4, 2 * rows * d


def dequant_fold_update(rows: int, d: int, qblock: int = QBLOCK) -> tuple:
    """(n, D) int8 codes with their (n, ceil(D / qblock)) fp32 scales,
    (n,) fp32 weights, the (D,) accumulator -> a new (D,) accumulator;
    a decode multiply, a weight multiply and an add an element."""
    nb = -(-d // qblock)
    return rows * d + rows * nb * 4 + rows * 4 + 2 * d * 4, 3 * rows * d


BYTES_OPS = {"similarity_stats": similarity_stats,
             "masked_aggregate": masked_aggregate,
             "masked_agg_update": masked_agg_update,
             "dequant_fold_update": dequant_fold_update}


def calls(traffic: dict, d: int) -> dict:
    """{kernel: [(rows, D), ...]}: the launches of one DiverseFL round
    (participation 1).  The dense round (f32 codec) computes the
    statistics and the masked mean over all N rows at once; the streaming
    round folds blocks of ``client_chunk`` rows, an f32 block with
    ``masked_agg_update`` and an int8 block with ``dequant_fold_update``
    (its statistics read the decoded fp32 rows)."""
    N = traffic["n_clients"]
    if not traffic["streaming"]:
        return {"similarity_stats": [(N, d)], "masked_aggregate": [(N, d)]}
    c = traffic.get("client_chunk") or N
    blocks = [(min(c, N - b0), d) for b0 in range(0, N, c)]
    fold = "dequant_fold_update" if traffic.get("compression") == "int8" \
        else "masked_agg_update"
    return {"similarity_stats": blocks, fold: blocks}


def round_least_s(kernel: str, traffic: dict, d: int) -> float:
    """The least time of ``kernel``'s launches in one round (0 if the
    round makes none)."""
    return sum(least_s(*BYTES_OPS[kernel](r, dd))
               for r, dd in calls(traffic, d).get(kernel, []))


def flat_dim(shapes: dict) -> int:
    return sum(math.prod(s) for s in shapes.values())
