"""The paper's 3-NN (784-200-200-10, ReLU), plain PyTorch at float32.

Weights are (in, out), biases (out,).  ``grads`` takes c clients' copies
of the same params and their batches at once: clients share nothing, so
the gradient of the summed losses is each client's own gradient.
"""
from __future__ import annotations

import torch

from .precision import Precision

LEAVES = ("w1", "b1", "w2", "b2", "w3", "b3")


class MLP3:
    block = 256          # clients a reference step computes at once

    def __init__(self, config: dict):
        self.sizes = (config["input_dim"], config["hidden"],
                      config["hidden"], config["n_classes"])

    def logits(self, p, x, prec: Precision):
        """p: leaves with a leading client axis c; x (c, m, in)."""
        h = torch.relu(prec.mm(x, p["w1"]) + p["b1"][:, None])
        h = torch.relu(prec.mm(h, p["w2"]) + p["b2"][:, None])
        return prec.mm(h, p["w3"]) + p["b3"][:, None]

    def grads(self, p32, xs, ys, l2: float, prec: Precision):
        """Each client's gradient of its mean cross entropy plus
        ``0.5 * l2 * sum |p|^2``: p32 unbatched fp32 leaves, xs (c, m,
        in), ys (c, m) -> {leaf: (c, ...)}."""
        c = xs.shape[0]
        leaves = {k: p32[k].unsqueeze(0).expand((c,) + tuple(p32[k].shape))
                  .clone().requires_grad_(True) for k in LEAVES}
        with torch.enable_grad():
            lg = self.logits(leaves, xs.reshape(c, xs.shape[1], -1).float(),
                             prec)
            nll = torch.nn.functional.cross_entropy(
                lg.reshape(-1, lg.shape[-1]), ys.reshape(-1).long(),
                reduction="none").reshape(c, -1).mean(1)
            if l2:
                nll = nll + 0.5 * l2 * sum(
                    (v * v).reshape(c, -1).sum(1) for v in leaves.values())
            g = torch.autograd.grad(nll.sum(), list(leaves.values()))
        return dict(zip(leaves, g))

