"""RSA [23] — Byzantine-robust stochastic aggregation (l1 consensus), in
PyTorch.

RSA is a *training protocol*, not a one-shot aggregator: every client j
keeps its own model copy theta_j and the master keeps theta_M; both take
signed-consensus steps (Eqs. 11-12).  Byzantine clients upload arbitrary
model copies.  Used only for the convex softmax-regression comparison
(the paper excludes RSA from the NN experiments).

The N client copies are client-batched params (a leading N axis), so
every client's gradient comes out of one ``SmallModel.grad`` call.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..core.attacks import flip_labels
from .simulator import FLConfig, Federation
from .small_models import SmallModel

Params = Dict[str, torch.Tensor]


def run_rsa(model: SmallModel, fed: Federation, cfg: FLConfig,
            lr_schedule: Callable, delta: float = 0.25, l2: float = 0.0067,
            generator: Optional[torch.Generator] = None, *,
            params: Optional[Params] = None,
            batch_idx: Optional[torch.Tensor] = None,
            noise: Optional[Sequence[Params]] = None) -> Dict:
    """``cfg.rounds`` RSA rounds on the federation's device.  Clients take
    their gradient without l2; the master adds ``l2 * theta_M``.

    Each round draws, from ``generator`` (default: seeded from
    ``cfg.seed`` on the device), the (N, batch_size) minibatch indices
    and then, under ``gaussian``, one standard normal per leaf of the
    client copies in the dict's order.  ``batch_idx`` (rounds, N, m) and
    ``noise`` (one dict of (N, ...) arrays a round) give them instead.
    The model starts from ``params``, or from ``model.init`` with a
    generator seeded from ``cfg.seed + 1``.  Returns the history: ``round``
    and ``acc`` every ``cfg.eval_every`` rounds and at the last,
    ``final_acc`` and ``params`` (theta_M)."""
    dev = fed.device
    acfg = cfg.attack
    N = cfg.n_clients
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    if params is None:
        params = model.init(
            torch.Generator(device=dev).manual_seed(cfg.seed + 1), dev)
    theta_m = {k: v.to(dev) for k, v in params.items()}
    theta_c = {k: v.unsqueeze(0).repeat((N,) + (1,) * v.dim())
               for k, v in theta_m.items()}
    byz = fed.byz_mask.to(dev)
    # a 0-d divisor: a CUDA tensor divided by a Python number is multiplied
    # by the reciprocal, which the reference does not do
    n_clients = torch.tensor(float(N), device=dev)

    def byz_rows(t):
        return byz.reshape((-1,) + (1,) * (t.dim() - 1))

    history = {"round": [], "acc": []}
    with torch.no_grad():
        for i in range(1, cfg.rounds + 1):
            lr = float(lr_schedule(i))
            xb, yb = fed.data.minibatch(
                cfg.batch_size, generator,
                idx=None if batch_idx is None else batch_idx[i - 1])
            if acfg.kind == "label_flip":
                yb = torch.where(byz[:, None],
                                 flip_labels(yb, fed.data.n_classes), yb)
            g = model.grad(theta_c, (xb, yb))
            theta_c = {k: t - lr * (g[k] / n_clients
                                    + delta * torch.sign(t - theta_m[k]))
                       for k, t in theta_c.items()}
            # Byzantine clients upload arbitrary copies; every other kind
            # (backdoor and scale too) leaves the copies as they are
            if acfg.kind == "gaussian":
                nz = noise[i - 1] if noise is not None else {
                    k: torch.randn(t.shape, generator=generator,
                                   device=generator.device)
                    for k, t in theta_c.items()}
                theta_c = {k: torch.where(byz_rows(t),
                                          nz[k].to(dev) * acfg.sigma, t)
                           for k, t in theta_c.items()}
            elif acfg.kind == "sign_flip":
                theta_c = {k: torch.where(byz_rows(t), -t, t)
                           for k, t in theta_c.items()}
            elif acfg.kind == "same_value":
                theta_c = {k: torch.where(byz_rows(t),
                                          torch.full_like(t, acfg.sigma), t)
                           for k, t in theta_c.items()}
            theta_m = {k: tm - lr * (l2 * tm + delta * torch.sign(
                tm - theta_c[k]).sum(0)) for k, tm in theta_m.items()}
            if i % cfg.eval_every == 0 or i == cfg.rounds:
                history["round"].append(i)
                history["acc"].append(
                    model.accuracy(theta_m, fed.test_x, fed.test_y))
    history["final_acc"] = history["acc"][-1]
    history["params"] = theta_m
    return history
