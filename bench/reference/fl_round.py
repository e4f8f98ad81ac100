"""One round of DiverseFL (arXiv:2010.07541, Algorithm 1), plain PyTorch.

Every client j runs E SGD steps on its minibatch from the round's params
and sends ``z_j = theta - theta_E``; a Byzantine client under
``sign_flip`` sends ``-z_j``.  The enclave runs the same E steps on the
client's shared sample for the guiding update ``g_j``.  Client j is kept
iff ``z_j . g_j > eps1`` (C1) and ``eps2 < |z_j| / |g_j| < eps3`` (C2),
and the params move by the mean of the kept updates (Eq. 6).  An SGD
step is computed in float32 and rounded once to the params' type, which
the configuration states; the differences and the statistics are float32
(the statistics accumulate in float64).

**The int8 uplink** (``codec="int8"``, :mod:`.int8`).  A client's update
travels as one flat row: its leaves flattened in the order ``wire``
names, the order of the program's flat update rows (the program's params
by sorted name, each a group of the reference's leaves), the codec's
blocks of 128 running across leaf boundaries.  The
sign flip sits before the codec: a Byzantine client flips ``z_j``, adds
its residual and encodes, so its residual carries the flipped row's
error.  Each client keeps its residual from round to round (``resid``,
one (D,) row a client, updated in place), starting at zero.  The
enclave's guide makes its own int8 round trip with no residual, per
program param: each group of ``wire`` flattened row-major and cut into
its own blocks.  Step
4's statistics are taken between the row the server decodes,
``dec(enc(±z_j + r_j))``, and that quantised guide; Step 5 moves the
params by the mean of the decoded rows of the kept clients.  These are
the rows the program's streamed round takes them on (``fl/streaming.py``:
the rule weighs the decoded block against the block's guides, and the
dequantize-and-fold kernel folds the same decoded rows; the guides are
quantised in ``fl/server.compute_guides``).

This file imports nothing of the program: the harness hands it the
inputs it made from the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from . import int8
from .precision import Precision

CODECS = ("f32", "int8")


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    lr: float
    l2: float
    local_steps: int
    attack: str = "sign_flip"
    eps1: float = 0.0
    eps2: float = 0.5
    eps3: float = 2.0


def _local(model, params, p32, xs, ys, spec: RoundSpec, prec: Precision):
    """E steps of c clients from ``params``: {leaf: (c, ...)} float32
    differences ``theta - theta_E``, each step rounded to the params'
    type.  ``xs`` (c, E, m, ...), ``ys`` (c, E, m)."""
    c = xs.shape[0]
    theta = None
    for e in range(spec.local_steps):
        cur = p32 if theta is None else None
        if theta is not None:
            # every client now holds its own params: step them one by one
            outs = [model.grads({k: v[i].float() for k, v in theta.items()},
                                xs[i:i + 1, e], ys[i:i + 1, e], spec.l2,
                                prec) for i in range(c)]
            g = {k: torch.cat([o[k] for o in outs]) for k in theta}
            theta = {k: (theta[k].float() - spec.lr * g[k]).to(v.dtype)
                     for k, v in theta.items()}
            continue
        g = model.grads(cur, xs[:, e], ys[:, e], spec.l2, prec)
        theta = {k: (p32[k].detach()[None] - spec.lr * g[k])
                 .to(params[k].dtype) for k in params}
        del g
    return {k: p32[k].detach()[None] - theta[k].float() for k in params}


def diversefl_round(model, params: Dict[str, torch.Tensor], xs, ys, gx, gy,
                    byz, spec: RoundSpec, prec: Precision = Precision(),
                    codec: str = "f32", wire: Optional[Sequence[Sequence[str]]] = None,
                    resid: Optional[torch.Tensor] = None):
    """One round: params (leaves in the configuration's type), the
    clients' minibatches xs (N, E, m, ...) / ys (N, E, m), the enclave's
    samples gx (N, s, ...) / gy (N, s), the Byzantine mask byz (N,); for
    ``codec="int8"`` the leaves' order on the wire, ``wire`` (groups of
    leaf names, one a program param), and the clients' residuals
    ``resid`` (N, D) float32, which the round updates.

    Returns ``(new params, c1c2 (N,), keep (N,))``, ``c1c2`` being
    ``sign(z.g) * |z| / |g|`` per client."""
    if spec.attack not in ("sign_flip", "none"):
        raise NotImplementedError(f"attack {spec.attack!r}")
    if codec not in CODECS:
        raise NotImplementedError(f"codec {codec!r}")
    lossy = codec == "int8"
    if lossy and (wire is None or resid is None):
        raise ValueError("the int8 uplink needs the wire order and the "
                         "clients' residuals")
    N = xs.shape[0]
    p32 = {k: v.detach().float().clone() for k, v in params.items()}
    acc = {k: torch.zeros_like(v) for k, v in p32.items()}
    dot = torch.zeros(N, dtype=torch.float64, device=xs.device)
    zz, gg = torch.zeros_like(dot), torch.zeros_like(dot)
    keep = torch.zeros(N, dtype=torch.bool, device=xs.device)
    acc_row = torch.zeros(resid.shape[1], device=xs.device) if lossy \
        else None
    for b0 in range(0, N, model.block):
        rows = slice(b0, min(N, b0 + model.block))
        z = _local(model, params, p32, xs[rows], ys[rows], spec, prec)
        if spec.attack == "sign_flip":
            flip = torch.where(byz[rows], -1.0, 1.0).float()
            z = {k: v * flip.reshape((-1,) + (1,) * (v.dim() - 1))
                 for k, v in z.items()}
        # the enclave repeats its E steps on the client's one sample
        E = spec.local_steps
        g = _local(model, params, p32,
                   gx[rows][:, None].expand((-1, E) + tuple(gx.shape[1:])),
                   gy[rows][:, None].expand(-1, E, -1), spec, prec)
        c = xs[rows].shape[0]
        if lossy:
            dec, resid[rows] = int8.feedback(
                torch.cat([z[k].reshape(c, -1) for grp in wire
                           for k in grp], 1), resid[rows])
            gq = torch.cat([int8.roundtrip(torch.cat(
                [g[k].reshape(c, -1) for k in grp], 1)) for grp in wire], 1)
            pairs = [(dec, gq)]
        else:
            pairs = [(z[k].reshape(c, -1), g[k].reshape(c, -1)) for k in z]
        for zk, gk in pairs:
            dot[rows] += (zk.double() * gk.double()).sum(1)
            zz[rows] += (zk.double() ** 2).sum(1)
            gg[rows] += (gk.double() ** 2).sum(1)
        del g, pairs
        ratio = zz[rows] / gg[rows].clamp_min(1e-30)
        keep[rows] = (dot[rows] > spec.eps1) & (ratio > spec.eps2 ** 2) & \
            (ratio < spec.eps3 ** 2)
        w = keep[rows].float()
        if lossy:
            acc_row += (dec * w[:, None]).sum(0)
            del dec
        else:
            for k in z:
                acc[k] += (z[k] * w.reshape((-1,) + (1,) * (z[k].dim() - 1))
                           ).sum(0)
        del z
    if lossy:
        off = 0
        for k in (k for grp in wire for k in grp):
            n = acc[k].numel()
            acc[k] = acc_row[off:off + n].reshape(acc[k].shape)
            off += n
    n = keep.sum().clamp_min(1).float()
    new = {k: (p32[k].detach() - acc[k] / n).to(params[k].dtype)
           for k in params}
    c1c2 = torch.sign(dot) * torch.sqrt(zz / gg.clamp_min(1e-30))
    return new, c1c2.float(), keep
