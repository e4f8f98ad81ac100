"""Per-client similarity statistics (DiverseFL Step 4): the CUDA kernel
``csrc/similarity.cu`` and its plain PyTorch version.

For (N, D) updates z and guides g, both return the (N, 3) fp32 matrix
[z·g, ‖z‖², ‖g‖²] per client row.  The CUDA kernel replaces the TPU
kernel ``src/repro/kernels/similarity.py`` ``similarity_kernel``.

The kernel cuts each row into fixed segments and reduces a row on one
thread-block cluster of :func:`cluster_size` blocks.  Where a row's
segments fall is its *plan* (:func:`row_plan`): a function of D and the
row's address mod 16 only, computed here for the four alignments and
passed to the kernel with the cluster size, a function of D.  A row's
reduction order, and so its bits, never depend on N, which lets a
streamed 8-row block give the bits of the same rows in the dense
matrix.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..core.diversefl import similarity_stats_matrix
from . import _build

# similarity_stats_f32(z, g, out, n, d, plan, cluster, stream) in
# csrc/similarity.cu
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
             ctypes.c_int, ctypes.c_void_p)

SEG_VEC = 2048            # float4s a segment (the kernel's kSegVec)
MAX_CLUSTER = 16          # blocks a row at most (the kernel's kMaxCluster)
ALIGN_OFFSETS = (0, 4, 8, 12)   # a row's byte address mod 16


class RowPlan(NamedTuple):
    """How the kernel walks one row: ``head`` scalars up to the row's first
    16-byte boundary (in segment 0), ``nvec`` float4s from there, segment
    s holding float4s [SEG_VEC·s, SEG_VEC·(s + 1)), the ``d - head -
    4·nvec`` scalars after them in the last of the ``nseg`` segments."""
    head: int
    nvec: int
    nseg: int


def row_plan(d: int, offset: int) -> RowPlan:
    """The plan of a row of ``d`` fp32 values whose address is ``offset``
    (0, 4, 8 or 12) mod 16."""
    if offset not in ALIGN_OFFSETS:
        raise ValueError(f"row_plan: offset must be one of {ALIGN_OFFSETS}, "
                         f"got {offset}")
    head = min((16 - offset) % 16 // 4, d)
    nvec = (d - head) // 4
    return RowPlan(head, nvec, max(1, -(-nvec // SEG_VEC)))


def plan_table(d: int) -> Tuple[RowPlan, ...]:
    """The plans of the four alignments, in ALIGN_OFFSETS order."""
    return tuple(row_plan(d, a) for a in ALIGN_OFFSETS)


def cluster_size(d: int) -> int:
    """Blocks that reduce one row of ``d`` values: the largest segment
    count over the four alignments, at most MAX_CLUSTER.  Block c walks
    segments c, c + C, ... and the cluster sums its blocks in rank order,
    so C, like the plan, is part of a row's reduction order."""
    return min(MAX_CLUSTER, max(p.nseg for p in plan_table(d)))


def similarity_plain(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the port's one definition of the statistics,
    :func:`~repro_torch.core.diversefl.similarity_stats_matrix` (three
    last-axis sums in fp32), stacked to the kernel's (N, 3) layout."""
    return torch.stack(similarity_stats_matrix(z, g), dim=-1)


def _check_operand(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"similarity_cuda: {name} must be a CUDA tensor, "
                         f"got device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"similarity_cuda: {name} must be float32, got "
                        f"{t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"similarity_cuda: {name} must be (N, D), got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"similarity_cuda: {name} must be contiguous")


def similarity_cuda(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: z, g (N, D) fp32
    contiguous CUDA tensors on one device -> (N, 3) fp32."""
    _check_operand("z", z)
    _check_operand("g", g)
    if z.shape != g.shape or z.device != g.device:
        raise ValueError(f"similarity_cuda: z {tuple(z.shape)} on {z.device} "
                         f"and g {tuple(g.shape)} on {g.device} must match")
    if (z.data_ptr() - g.data_ptr()) % 16:
        raise ValueError("similarity_cuda: z and g must share their 16-byte "
                         "alignment (the kernel's float4 loads read both "
                         "rows at the same offset)")
    n, d = z.shape
    out = torch.empty((n, 3), dtype=torch.float32, device=z.device)
    if n == 0:
        return out
    if n > 65535:
        raise ValueError(f"similarity_cuda: at most 65535 rows, got {n}")
    table = plan_table(d)
    plan = (ctypes.c_int64 * 12)(*[p.head for p in table],
                                 *[p.nvec for p in table],
                                 *[p.nseg for p in table])
    fn = _build.entry_point("similarity", "similarity_stats_f32", _ARGTYPES)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = fn(z.data_ptr(), g.data_ptr(), out.data_ptr(), n, d, plan,
                  cluster_size(d), stream)
    _build.check("similarity", code)
    similarity_cuda.launches += 1
    return out


similarity_cuda.launches = 0
