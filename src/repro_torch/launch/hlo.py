"""What the reference reads from compiled HLO, read from the port's trace:
collective bytes, an op census and roofline terms.

The reference parses XLA's HLO text.  The port has no HLO: a step runs
eagerly, so its counterpart counts what a traced run of the step records
(``launch/dryrun.py``):

- the collectives, one record a call of ``sharding.all_reduce`` or
  ``sharding.all_gather``, the only places the port issues one
  (``sharding.record_collectives``): ``{"kind", "dtype", "shape",
  "group_size"}``, with ``shape`` the input's;
- the aten ops the dispatcher ran, by name, with the port's kernel
  wrappers' launches beside them under the wrappers' names.

Per-rank moved bytes are estimated as in the reference, result bytes x
``FACTOR`` (an all-reduce counts twice for its reduce and broadcast
phases; the ring's (N-1)/N ~ 1 is folded in).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.float16: 2, torch.bfloat16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# traffic factor per result byte (ring algorithms, large N)
FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
          "all-to-all": 1.0, "collective-permute": 1.0}

# the aten ops of each of the reference's op families (overload packets);
# "custom-call" is the port's kernel wrappers (kernels/ops.KERNELS).  Under
# torch.inference_mode() (the serving steps) the dispatcher hands
# composite ops such as matmul and einsum on whole, so they count too
OP_FAMILIES = {
    "dot": ("mm", "bmm", "addmm", "baddbmm", "matmul", "einsum", "linear",
            "mv", "addmv", "dot"),
    "convolution": ("convolution",),
    "scatter": ("scatter", "scatter_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_", "index_put",
                "index_put_", "index_add", "index_add_"),
    "gather": ("gather", "index_select", "index", "embedding"),
}


def _result_bytes(rec: Mapping) -> int:
    n = 1
    for d in rec["shape"]:
        n *= int(d)
    n *= DTYPE_BYTES[rec["dtype"]]
    return n * int(rec["group_size"]) if rec["kind"] == "all-gather" else n


def collective_stats(records: Iterable[Mapping]) -> Dict[str, dict]:
    """Per collective kind: {count, result_bytes, moved_bytes}; zeros for
    the kinds the port never issues."""
    stats = {k: {"count": 0, "result_bytes": 0, "moved_bytes": 0.0}
             for k in COLLECTIVES}
    for rec in records:
        rbytes = _result_bytes(rec)
        s = stats[rec["kind"]]
        s["count"] += 1
        s["result_bytes"] += rbytes
        s["moved_bytes"] += rbytes * FACTOR[rec["kind"]]
    return stats


def total_collective_bytes(records: Iterable[Mapping]) -> float:
    return sum(v["moved_bytes"] for v in collective_stats(records).values())


def op_census(ops: Mapping[str, int]) -> Dict[str, int]:
    """``ops``: how often each op ran, keyed by aten overload packet name
    (``"mm"``, ``"index_put_"``), by a kernel wrapper's name
    (``kernels.ops.KERNELS``), or by a collective kind (``"all-reduce"``:
    the records' count).  Returns the reference's families: ``dot``,
    ``convolution``, ``scatter``, ``gather``, ``custom-call`` (kernel
    launches; 0 on the plain path), ``fusion`` (always 0: eager PyTorch
    fuses nothing, so every op of a fusion XLA would make is counted on
    its own) and the five collective kinds."""
    from ..kernels.ops import KERNELS
    census = {"fusion": 0,
              "custom-call": sum(ops.get(k, 0) for k in KERNELS)}
    for fam, names in OP_FAMILIES.items():
        census[fam] = sum(ops.get(n, 0) for n in names)
    for kind in COLLECTIVES:
        census[kind] = ops.get(kind, 0)
    return census


# ----------------------------------------------------------------------
# Roofline figures: NVIDIA H100 80GB HBM3 (SXM), 700 W, NVIDIA's data
# sheet, dense rates without sparsity
# ----------------------------------------------------------------------
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor cores, per card
HBM_BW = 3.35e12                # bytes/s per card
NVLINK_BW_PER_LINK = 25e9       # bytes/s per NVLink 4 link, one direction
NVLINK_LINKS = 18               # links per card


def roofline_terms(cost: dict, collective_bytes: float) -> dict:
    """cost: ``{"flops", "bytes accessed"}`` of one rank's step
    (``launch/dryrun.py``)."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_accessed / HBM_BW
    t_collective = collective_bytes / (NVLINK_BW_PER_LINK * NVLINK_LINKS)
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)), key=lambda kv: kv[1])[0]
    return {"flops": flops, "bytes": bytes_accessed,
            "collective_bytes": collective_bytes,
            "t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective, "dominant": dominant}
