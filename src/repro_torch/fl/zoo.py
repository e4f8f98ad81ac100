"""Federate the real model zoo: the ``models/`` + ``configs/`` stack on the
port's round engine.  The counterpart of ``repro/fl/zoo.py``.

The engine's model contract is ``fl/small_models.SmallModel``'s:
``init(generator, device)``, ``apply(params, x) -> logits``,
``loss(params, x, y, l2)``, ``grad(params, batch, l2)`` over
client-batched params, an ``input_shape`` and ``n_classes``.
:class:`ZooModel` meets it for any decoder-only
:class:`~repro_torch.models.ModelConfig` by casting the paper's
classification framing onto language modelling, as the reference does:

  * an example is a token sequence of length ``seq_len + 1``; ``x`` is
    its first ``seq_len`` tokens, ``y`` the last, so next-token
    prediction is the classification task (``n_classes = vocab_size``)
    and every attack, metric and eval path works unchanged;
  * ``loss`` is the full-sequence LM loss over the re-joined
    ``concat(x, y)`` (``models.loss_fn``, MoE aux term included), so
    local SGD trains every position; ``apply`` returns the last
    position's next-token logits.

**Flat params.**  The engine, the SecureServer, the streaming fold, the
telemetry and ``comm_stats`` all take params as one flat ``{name:
tensor}`` dict and lay it out in sorted key order.  ``ZooModel.init``
returns the zoo's nested tree in that form: one key per leaf, prefixed
with the leaf's zero-padded position in JAX's leaf order
(``convert.flatten_tree``), so the sorted keys ARE the reference's leaf
order and the flat update D matches the reference's column for column.
``apply``, ``loss`` and ``grad`` rebuild the nested tree from the flat
dict as the same tensors (no copies).

**Tensor parallelism.**  On a model axis > 1 (the round engine's mesh)
the flat dict holds this rank's tiles (``sharding.place_params``):
``apply``, ``loss`` and ``grad`` run the zoo split over the model group,
and ``grad`` returns tile-shaped gradients.

Token ids survive the enclave's fp32 seal (``core/tee.py``) exactly up to
2^24, far beyond any vocab; ``loss`` and ``apply`` round them back to
int64 at the boundary.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import models
from ..convert import flatten_tree, unflatten_like
from ..data.pipeline import FederatedData
from ..data.synthetic import make_token_stream
from ..device import DeviceLike, resolve_device
from ..models import ModelConfig
from ..sharding.api import reduce_from_model

Params = Dict[str, torch.Tensor]


def _as_tokens(x: torch.Tensor) -> torch.Tensor:
    """int64 token ids from whatever the pipeline delivered: the enclave
    seals fp32, so guide batches come back float; ids are exact in fp32
    up to 2^24, so rounding recovers them."""
    if not torch.is_floating_point(x):
        return x.to(torch.int64)
    return torch.round(x).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """A zoo :class:`ModelConfig` wearing the SmallModel contract.

    ``loss`` takes the ``l2`` knob for interface parity, but zoo runs
    should set ``l2=0.0``: a ridge over 10^8 bf16 parameters is neither
    the paper's setting nor numerically meaningful."""
    name: str
    cfg: ModelConfig
    seq_len: int

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return (self.seq_len,)

    @property
    def n_classes(self) -> int:
        return self.cfg.vocab_size

    def param_count(self) -> int:
        return self.cfg.param_count()

    @functools.cached_property
    def _skeleton(self):
        """The nested params structure (meta tensors: nothing stored)."""
        return models.init(None, self.cfg, "meta")

    @functools.cached_property
    def like(self) -> Params:
        """The flat params at their whole shapes (meta tensors)."""
        return flatten_tree(self._skeleton)

    def tree(self, params: Params):
        """The flat dict -> the nested params tree (the same tensors)."""
        return unflatten_like(self._skeleton,
                              [params[k] for k in sorted(params)])

    def init(self, generator: Optional[torch.Generator],
             device: DeviceLike = None) -> Params:
        """Random params from ``generator`` (``models.init``), flat."""
        return flatten_tree(models.init(generator, self.cfg,
                                        resolve_device(device)))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Last-position next-token logits, (B, vocab_size) fp32: the
        classification head the metrics score."""
        tree = self.tree(params)
        out = models.apply(tree, self.cfg, _as_tokens(x))
        lg = models.logits(tree, self.cfg, out["hidden"][:, -1:, :])
        return lg[:, 0, :self.cfg.vocab_size]

    def loss(self, params: Params, x: torch.Tensor, y: torch.Tensor,
             l2: float = 0.0) -> torch.Tensor:
        """Full-sequence LM loss over ``concat(x, y)``, plus
        ``0.5 * l2 * Σ‖p‖²`` in fp32: every position trains, and the last
        position's target is exactly ``y``."""
        tok = torch.cat([_as_tokens(x), _as_tokens(y)[..., None]], dim=-1)
        nll = models.loss_fn(self.tree(params), self.cfg, {"tokens": tok})
        if l2:
            sq = {k: torch.sum(torch.square(params[k].float()))
                  for k in sorted(params)}
            tiled = [k for k in sq
                     if params[k].shape != self.like[k].shape]
            if tiled:
                # a tile's term is the rank's share: the group's sum
                # counts each whole leaf once
                ridge = sum(v for k, v in sq.items() if k not in tiled) + \
                    reduce_from_model(sum(sq[k] for k in tiled))
            else:
                ridge = sum(sq.values())
            nll = nll + 0.5 * l2 * ridge
        return nll

    def grad(self, params: Params, batch, l2: float = 0.0) -> Params:
        """Per-client gradients of :meth:`loss`: every leaf of ``params``
        and of ``batch = (x (c, m, S), y (c, m))`` leads with the client
        axis c, and so does every gradient (in the params' dtype).  One
        client at a time, each its own ``torch.autograd.grad``; a leaf the
        loss does not reach gets zeros, as ``jax.grad`` gives."""
        x, y = batch
        keys = list(params)
        per_client = []
        for i in range(int(x.shape[0])):
            leaves = {k: params[k][i].detach().requires_grad_(True)
                      for k in keys}
            with torch.enable_grad():
                total = self.loss(leaves, x[i], y[i], l2)
                gs = torch.autograd.grad(total, list(leaves.values()),
                                         allow_unused=True)
            per_client.append([torch.zeros_like(leaves[k]) if g is None
                               else g for k, g in zip(keys, gs)])
        if len(per_client) == 1:
            return {k: g.unsqueeze(0) for k, g in zip(keys, per_client[0])}
        return {k: torch.stack([gs[j] for gs in per_client])
                for j, k in enumerate(keys)}

    def accuracy(self, params: Params, x: torch.Tensor, y: torch.Tensor,
                 batch: int = 256) -> float:
        """Next-token top-1 accuracy as a host float, ``batch`` rows of
        ``x`` at a time."""
        correct, n = 0, int(y.shape[0])
        with torch.no_grad():
            for i in range(0, n, batch):
                lg = self.apply(params, x[i:i + batch])
                correct += int((lg.argmax(-1) == y[i:i + batch]).sum())
        return correct / n


def zoo_model(arch, seq_len: int = 64, smoke: bool = True) -> ZooModel:
    """A :class:`ZooModel` from an arch id (``configs.get``), or wrap an
    explicit :class:`ModelConfig` (``arch`` may be either)."""
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        from .. import configs
        cfg = configs.get(arch, smoke=smoke)
    if cfg.is_enc_dec or cfg.has_cross:
        raise ValueError(
            f"{cfg.name!r} needs encoder/cross-attention inputs "
            f"(enc_emb/cross_emb) that the FL data pipeline does not "
            f"carry — federate a decoder-only arch, or extend "
            f"FederatedData with modality sidecars first")
    return ZooModel(name=cfg.name, cfg=cfg, seq_len=seq_len)


def make_zoo_data(generator: Optional[torch.Generator], model: ZooModel,
                  n_clients: int, per_client: int, n_test: int = 64, *,
                  u: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None):
    """Synthetic federated token data for ``model``: per-client stacks of
    (seq_len + 1)-token examples split into (x = prefix, y = next token),
    plus a held-out test split.  -> ``(FederatedData, test_x, test_y)``.
    The token stream's draws come from ``generator`` or are given as
    ``u``/``shift`` (``data.synthetic.make_token_stream``)."""
    total = n_clients * per_client + n_test
    S = model.seq_len
    toks = make_token_stream(generator, total, S + 1, model.cfg.vocab_size,
                             u=u, shift=shift)
    tr = toks[:n_clients * per_client].reshape(n_clients, per_client, S + 1)
    data = FederatedData(x=tr[:, :, :S], y=tr[:, :, S],
                         n_classes=model.cfg.vocab_size)
    te = toks[n_clients * per_client:]
    return data, te[:, :S], te[:, S]


def make_zoo_federation(model: ZooModel, cfg,
                        generator: Optional[torch.Generator] = None,
                        per_client: int = 32, n_test: int = 64,
                        device: DeviceLike = None):
    """Data, sealed enclave samples and a SecureServer for a zoo model on
    ``device`` (the card unless given): ``Federation.create`` on synthetic
    token shards, every draw from ``generator`` (default: seeded with
    ``cfg.seed + 17`` on the device), the data first.  Drive it with
    ``run_federated_training(model, fed, cfg, ...)`` or a
    :class:`~repro_torch.fl.engine.RoundEngine`."""
    from .simulator import Federation
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed + 17)
    data, tx, ty = make_zoo_data(generator, model, cfg.n_clients,
                                 per_client, n_test)
    return Federation.create(model, data, tx, ty, cfg, generator,
                             device=dev)
