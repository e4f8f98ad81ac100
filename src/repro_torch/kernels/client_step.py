"""The client step's epilogue: the CUDA kernel ``csrc/client_step.cu``
and its plain PyTorch version.

For a block of c clients, one local SGD step from the params ``thetap``
with the per-client data-loss gradients ``grads``, and the params
``theta0`` the clients started from, both write the block's update rows
straight into a caller's fp32 matrix ``out``:

    out[row0 + i, col_k + j] =
        θ0_k[i, j] - round(θp_k[i, j] - lr·(g_k[i, j] + l2·θp_k[i, j]))

for the first ``rows`` clients (default all c), leaf k at the columns of
``core/aggregators.flatten_updates`` (leaves in the order given, each
ravelled).  ``round`` rounds to the params' dtype once, as
``core/diversefl.sgd_round_once`` does; the ridge term ``l2·θ`` is the
gradient of the models' ``0.5·l2·Σ‖p‖²``, so the model's own gradient is
taken with ``l2 = 0``.  Every leaf list holds (c, ...) tensors; a leaf of
θ0 or θp may be a zero-stride ``expand`` of params every client shares.

It replaces no TPU kernel: the reference leaves the step to XLA's fusion,
which the port's eager path cannot do.  The kernel is bound by HBM bytes
(the gradients read once, the rows written once); its design note is in
the source.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _build

# client_step_rows(g, t0, tp, meta, count, is_bf16, out, ld, row0, rows,
# lr_ptr, lr, l2, stream) in csrc/client_step.cu
_ARGTYPES = (ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p)

MAX_LEAVES = 32       # leaves a launch (the kernel's kMaxLeaves)
DTYPES = (torch.float32, torch.bfloat16)


def _rows(t: torch.Tensor, c: int) -> torch.Tensor:
    """A (c, ...) leaf as (c, n): a view where the trailing dims allow it
    (a zero-stride client axis stays zero-stride)."""
    return t.reshape(c, -1)


def client_step_rows_plain(out: torch.Tensor, grads: Sequence[torch.Tensor],
                           theta0: Sequence[torch.Tensor],
                           thetap: Sequence[torch.Tensor], lr, l2: float,
                           row0: int = 0,
                           rows: Optional[int] = None) -> torch.Tensor:
    """The plain version, leaf by leaf in fp32: the same operations, each
    rounded once, in the kernel's order (so the two agree bit for bit).
    ``lr`` is a number or a 0-d tensor.  Returns ``out``."""
    col = 0
    for g, t0, tp in zip(grads, theta0, thetap):
        c = g.shape[0]
        n = c if rows is None else rows
        p = _rows(tp, c)[:n].float()
        gl = _rows(g, c)[:n].float()
        if l2:
            gl = gl + l2 * p
        tn = (p - lr * gl).to(tp.dtype).float()
        w = gl.shape[1]
        out[row0:row0 + n, col:col + w] = _rows(t0, c)[:n].float() - tn
        col += w
    return out


def _check(out, grads, theta0, thetap, row0, rows):
    fn = "client_step_rows_cuda"
    if not out.is_cuda or out.dtype != torch.float32 or out.dim() != 2 \
            or out.stride(1) != 1:
        raise ValueError(f"{fn}: out must be a CUDA fp32 (R, D) matrix with "
                         f"unit column stride, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if not (len(grads) == len(theta0) == len(thetap)) or not grads:
        raise ValueError(f"{fn}: grads, theta0 and thetap must list the "
                         f"same leaves")
    c = grads[0].shape[0]
    dtype = grads[0].dtype
    if dtype not in DTYPES:
        raise TypeError(f"{fn}: the params must be one of {DTYPES}, got "
                        f"{dtype}")
    width = 0
    for t in (*grads, *theta0, *thetap):
        if t.dtype != dtype or t.device != out.device or t.shape[0] != c:
            raise ValueError(f"{fn}: every leaf must be (c={c}, ...) "
                             f"{dtype} on {out.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for g in grads:
        width += g[0].numel()
    if rows > c or row0 < 0 or row0 + rows > out.shape[0] \
            or width != out.shape[1]:
        raise ValueError(f"{fn}: rows {row0}..{row0 + rows - 1} of {c} "
                         f"clients' {width} columns do not fit out "
                         f"{tuple(out.shape)}")


def client_step_rows_cuda(out: torch.Tensor, grads: Sequence[torch.Tensor],
                          theta0: Sequence[torch.Tensor],
                          thetap: Sequence[torch.Tensor], lr, l2: float,
                          row0: int = 0,
                          rows: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: every leaf (c, ...)
    fp32 or bf16 (all one dtype) on ``out``'s device, ``out`` (R, D) fp32
    with unit column stride and D the leaves' columns.  A leaf's client
    axis may have stride 0 (shared params); within a client its elements
    must be contiguous (they are made so otherwise).  ``lr`` is a number
    or a 0-d tensor, read on the device when it is a CUDA tensor (no host
    read).  One launch per MAX_LEAVES leaves.  Returns ``out``."""
    c = grads[0].shape[0] if grads else 0
    rows = c if rows is None else rows
    _check(out, grads, theta0, thetap, row0, rows)
    if rows == 0:
        return out
    keep = []           # the operands stay alive through the launch
    gp, zp, pp, meta = [], [], [], []
    col = 0
    for g, t0, tp in zip(grads, theta0, thetap):
        views = []
        for t in (g, t0, tp):
            v = _rows(t, c)
            if v.stride(1) != 1:
                v = v.contiguous()
            views.append(v)
        keep.append(views)
        n = views[0].shape[1]
        gp.append(views[0].data_ptr())
        zp.append(views[1].data_ptr())
        pp.append(views[2].data_ptr())
        meta += [views[0].stride(0), views[1].stride(0), views[2].stride(0),
                 n, col]
        col += n
    lr_ptr, lr_val = None, 0.0
    if torch.is_tensor(lr) and lr.is_cuda:
        lr_t = lr.to(device=out.device, dtype=torch.float32).reshape(())
        keep.append(lr_t)
        lr_ptr = lr_t.data_ptr()
    else:
        lr_val = float(lr)
    k = len(gp)
    ptrs = ctypes.c_void_p * k
    fn = _build.entry_point("client_step", "client_step_rows", _ARGTYPES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = fn(ptrs(*gp), ptrs(*zp), ptrs(*pp),
                  (ctypes.c_int64 * len(meta))(*meta), k,
                  int(grads[0].dtype == torch.bfloat16), out.data_ptr(),
                  out.stride(0), row0, rows, lr_ptr, lr_val, float(l2),
                  stream)
    _build.check("client_step", code)
    live = sum(1 for m in range(k) if meta[5 * m + 3] > 0)
    client_step_rows_cuda.launches += -(-live // MAX_LEAVES)
    return out


client_step_rows_cuda.launches = 0
