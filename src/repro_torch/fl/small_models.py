"""Paper-scale models (Sec. IV) in PyTorch: softmax regression, the
3-layer MLP ("3-NN", 200-200 hidden), the Appendix-C small CNN and VGG-11
with group norm.

A model is functional, like the reference's: ``init(generator, device)
-> params`` (a dict of tensors), ``apply(params, x) -> logits``.  Params
keep the reference's layout — dense weights are (in, out), convolution
weights HWIO (kh, kw, cin, cout), images NHWC — so ``flatten_updates``
gives the reference's columns and ``convert.params_from_jax`` carries
params over unchanged.  Params may carry a leading client axis: with
every leaf (C, ...) and ``x`` (C, m, ...), ``apply`` and ``loss``
evaluate C independent models at once, which is how the port runs every
client's local SGD in one batched pass.  Dense layers are batched
matmuls; the C clients' convolutions are one grouped convolution
(``groups=C``) over a client-major channel axis, and their group norms
one ``F.group_norm`` over C times the groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SmallModel:
    name: str
    init: Callable                     # (generator, device) -> params
    apply: Callable                    # (params, x) -> logits
    input_shape: tuple
    n_classes: int

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor,
             l2: float = 0.0) -> torch.Tensor:
        """Mean cross-entropy plus ``0.5 * l2 * Σ‖p‖²``.  Scalar for plain
        params; one loss per client, shape (C,), for client-batched ones."""
        logits = self.apply(params, x)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, y.unsqueeze(-1)).squeeze(-1).mean(-1)
        if l2:
            nb = nll.dim()                 # 0 plain, 1 client-batched
            nll = nll + 0.5 * l2 * sum(
                (p * p).flatten(nb).sum(-1) for p in params.values())
        return nll

    def grad(self, params: Params, batch, l2: float = 0.0) -> Params:
        """Gradient of :meth:`loss` for every parameter.  With
        client-batched params the per-client losses are summed before the
        backward pass: clients share no parameter, so each client's slice
        of the gradient is its own loss's gradient."""
        x, y = batch
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            total = self.loss(leaves, x, y, l2).sum()
            grads = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, grads))


def _glorot(generator: torch.Generator, shape, device) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    fan_out = shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2 * lim) - lim).to(device)


def softmax_regression(input_dim: int = 784, n_classes: int = 10,
                       zero_init: bool = True) -> SmallModel:
    def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        w = torch.zeros((input_dim, n_classes), device=dev) if zero_init \
            else _glorot(generator, (input_dim, n_classes), dev)
        return {"w": w, "b": torch.zeros((n_classes,), device=dev)}

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        w, b = params["w"], params["b"]
        lead = w.dim() - 1                 # (m,) plain, (C, m) batched
        h = x.reshape(tuple(x.shape[:lead]) + (-1,))
        return h @ w + b.unsqueeze(-2)
    return SmallModel("softmax_regression", init, apply,
                      (input_dim,), n_classes)


def _glorot_conv(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Glorot-uniform HWIO (kh, kw, cin, cout) convolution weights."""
    rf = shape[0] * shape[1]
    lim = math.sqrt(6.0 / (rf * shape[2] + rf * shape[3]))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2 * lim) - lim).to(device)


def _zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((n,), device=device)


def _per_client(apply_batched: Callable, probe: str, plain_dim: int):
    """``apply`` for plain or client-batched params: plain params (leaf
    ``probe`` of rank ``plain_dim``) run as one client."""
    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        if params[probe].dim() == plain_dim:
            one = {k: v.unsqueeze(0) for k, v in params.items()}
            return apply_batched(one, x.unsqueeze(0))[0]
        return apply_batched(params, x)
    return apply


def _dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, m, in) @ (C, in, out) + (C, out) -> (C, m, out)."""
    return torch.matmul(h, w) + b.unsqueeze(-2)


def mlp3(input_dim: int = 784, n_classes: int = 10,
         hidden: int = 200) -> SmallModel:
    """The paper's 3-NN: two hidden layers of 200 neurons."""
    def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        return {"w1": _glorot(generator, (input_dim, hidden), dev),
                "b1": _zeros(hidden, dev),
                "w2": _glorot(generator, (hidden, hidden), dev),
                "b2": _zeros(hidden, dev),
                "w3": _glorot(generator, (hidden, n_classes), dev),
                "b3": _zeros(n_classes, dev)}

    def apply_batched(p: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(tuple(x.shape[:2]) + (-1,))
        h = torch.relu(_dense(h, p["w1"], p["b1"]))
        h = torch.relu(_dense(h, p["w2"], p["b2"]))
        return _dense(h, p["w3"], p["b3"])
    return SmallModel("mlp3", init, _per_client(apply_batched, "w1", 2),
                      (input_dim,), n_classes)


# ----------------------------------------------------------------------
# Convolutional models: C clients' NHWC images in one grouped layout
# ----------------------------------------------------------------------

def _to_grouped(x: torch.Tensor) -> torch.Tensor:
    """(C, m, H, W, ch) NHWC per client -> (m, C*ch, H, W), client-major
    channels."""
    c, m, h, w, ch = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(m, c * ch, h, w)


def _from_grouped(h: torch.Tensor, c: int) -> torch.Tensor:
    """(m, C*ch, H, W) -> (C, m, H, W, ch), the reference's NHWC."""
    m, cc, hh, ww = h.shape
    return h.reshape(m, c, cc // c, hh, ww).permute(1, 0, 3, 4, 2)


def _conv(h: torch.Tensor, w: torch.Tensor, b, padding: str) -> torch.Tensor:
    """Each client's stride-1 convolution with its own HWIO weights
    ``w`` (C, kh, kw, cin, cout) and bias ``b`` (C, cout) or None, as one
    grouped convolution of the grouped layout."""
    c, kh, kw, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(c * cout, cin, kh, kw)
    return F.conv2d(h, wt, None if b is None else b.reshape(-1),
                    padding=padding, groups=c)


def small_cnn(n_classes: int = 10) -> SmallModel:
    """Appendix C table V: conv 3->16 (3x3, pad1) + relu + maxpool3s3,
    conv 16->64 (4x4, valid) + relu + maxpool4s4, fc 64-384-192-C."""
    def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        return {"c1": _glorot_conv(generator, (3, 3, 3, 16), dev),
                "cb1": _zeros(16, dev),
                "c2": _glorot_conv(generator, (4, 4, 16, 64), dev),
                "cb2": _zeros(64, dev),
                "w1": _glorot(generator, (64, 384), dev), "b1": _zeros(384, dev),
                "w2": _glorot(generator, (384, 192), dev), "b2": _zeros(192, dev),
                "w3": _glorot(generator, (192, n_classes), dev),
                "b3": _zeros(n_classes, dev)}

    def apply_batched(p: Params, x: torch.Tensor) -> torch.Tensor:
        c, m = x.shape[:2]
        h = torch.relu(_conv(_to_grouped(x), p["c1"], p["cb1"], "same"))
        h = F.max_pool2d(h, 3, 3)                 # VALID pooling: floor mode
        h = torch.relu(_conv(h, p["c2"], p["cb2"], "valid"))
        h = F.max_pool2d(h, 4, 4)
        h = _from_grouped(h, c).reshape(c, m, -1)[..., :64]
        h = torch.relu(_dense(h, p["w1"], p["b1"]))
        h = torch.relu(_dense(h, p["w2"], p["b2"]))
        return _dense(h, p["w3"], p["b3"])
    return SmallModel("small_cnn", init, _per_client(apply_batched, "c1", 4),
                      (32, 32, 3), n_classes)


def vgg11(n_classes: int = 10, gn_group_channels: int = 16) -> SmallModel:
    """Table I VGG-11 with group norm (16 channels/group), avg-pool head.
    Dropout is omitted, as in the reference.  Group norm uses the
    population variance, as ``F.group_norm`` does, with eps 1e-5."""
    chans = [(3, 64), (64, 128), (128, 256), (256, 256),
             (256, 512), (512, 512), (512, 512), (512, 512)]
    pool_after = {0, 1, 3, 7}           # keep spatial dims manageable at 32x32

    def init(generator: torch.Generator, device: DeviceLike = None) -> Params:
        dev = resolve_device(device)
        p = {}
        for i, (ci, co) in enumerate(chans):
            p[f"c{i}"] = _glorot_conv(generator, (3, 3, ci, co), dev)
            p[f"gs{i}"] = torch.ones((co,), device=dev)
            p[f"gb{i}"] = torch.zeros((co,), device=dev)
        p["w1"] = _glorot(generator, (512, 4096), dev)
        p["b1"] = torch.zeros((4096,), device=dev)
        p["w2"] = _glorot(generator, (4096, 4096), dev)
        p["b2"] = torch.zeros((4096,), device=dev)
        p["w3"] = _glorot(generator, (4096, n_classes), dev)
        p["b3"] = torch.zeros((n_classes,), device=dev)
        return p

    def apply_batched(p: Params, x: torch.Tensor) -> torch.Tensor:
        c, m = x.shape[:2]
        h = _to_grouped(x)
        for i, (_, co) in enumerate(chans):
            h = _conv(h, p[f"c{i}"], None, "same")
            h = F.group_norm(h, c * (co // gn_group_channels),
                             p[f"gs{i}"].reshape(-1), p[f"gb{i}"].reshape(-1),
                             eps=1e-5)
            h = torch.relu(h)
            if i in pool_after:
                h = F.max_pool2d(h, 2, 2)
        h = h.mean((2, 3)).reshape(m, c, -1).transpose(0, 1)  # (C, m, 512)
        h = torch.relu(_dense(h, p["w1"], p["b1"]))
        h = torch.relu(_dense(h, p["w2"], p["b2"]))
        return _dense(h, p["w3"], p["b3"])
    return SmallModel("vgg11", init, _per_client(apply_batched, "c0", 4),
                      (32, 32, 3), n_classes)
