"""Federated-learning simulator — Algorithm 1 at simulator scale, in
PyTorch, as an eager per-round loop.

Each round (``make_round_body``): clients run E local SGD steps on fresh
minibatches, all clients at once in one batched pass; Byzantine clients
corrupt their data (label flip, backdoor) or their updates (gaussian,
sign flip, same value, scaling); the SecureServer computes the guiding
updates from the unsealed enclave samples (DiverseFL) or the root update
from its root set (FLTrust) and hands Steps 4-5 to the aggregator
registry, whose weighted-mean rules run on the CUDA kernels on the card.

Nothing inside a round waits on the card: the metrics leave the device
only at eval points.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from ..core.aggregators import flatten_updates
from ..core.attacks import (UPDATE_ATTACKS, AttackConfig, attack_update,
                            flip_labels, make_byzantine_mask, poison_backdoor)
from ..core.diversefl import DiverseFLConfig
from ..data.pipeline import FederatedData
from ..device import DeviceLike, resolve_device
from .metrics import BackdoorEval, make_backdoor_eval, make_eval_fn
from .server import AggregationContext, SecureServer, get_aggregator
from .small_models import SmallModel


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int = 23
    f: int = 5
    rounds: int = 100
    local_steps: int = 1                 # E
    batch_size: int = 30                 # m
    l2: float = 0.0067
    aggregator: str = "diversefl"
    attack: AttackConfig = AttackConfig()
    dfl: DiverseFLConfig = DiverseFLConfig()
    sample_frac: float = 0.01            # enclave sample s / n_j
    root_frac: float = 0.01              # FLTrust root dataset fraction
    resample_s: int = 2                  # Resampling s_R
    participation: float = 1.0           # C = ceil(participation * N) <= N
    eval_every: int = 10
    seed: int = 0

    def __post_init__(self):
        get_aggregator(self.aggregator)   # unknown rule -> named ValueError
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{self.participation!r}")

    @property
    def n_selected(self) -> int:
        return max(1, min(self.n_clients,
                          math.ceil(self.participation * self.n_clients)))


@dataclasses.dataclass
class Federation:
    model: SmallModel
    data: FederatedData
    test_x: torch.Tensor
    test_y: torch.Tensor
    byz_mask: torch.Tensor                  # (N,) bool — ground truth
    server: SecureServer                    # owns the enclave + registry
    root_x: Optional[torch.Tensor] = None   # FLTrust root dataset
    root_y: Optional[torch.Tensor] = None
    _bd_eval: Optional[BackdoorEval] = dataclasses.field(
        default=None, repr=False)           # cached trigger-stamped test set

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def enclave(self):
        return self.server.enclave

    def backdoor_eval(self, acfg: AttackConfig) -> BackdoorEval:
        """The trigger-stamped backdoor test set, built once per
        federation (per source/target pair)."""
        bd = self._bd_eval
        if bd is None or (bd.source_class, bd.target_class) != \
                (acfg.source_class, acfg.target_class):
            bd = make_backdoor_eval(self.test_x, self.test_y, acfg)
            self._bd_eval = bd
        return bd

    @classmethod
    def create(cls, model: SmallModel, data: FederatedData, test_x, test_y,
               cfg: FLConfig, generator: Optional[torch.Generator] = None, *,
               device: DeviceLike = None,
               enclave_idx: Optional[torch.Tensor] = None,
               root_idx: Optional[torch.Tensor] = None) -> "Federation":
        """Steps 0-1 on ``device`` (the card unless given): place the data,
        attest the server, and seal each client's shared sample; then pick
        FLTrust's root set, a random subset of root_frac of the union of
        the client data.  The draws come from ``generator`` (default:
        seeded from ``cfg.seed`` on the device), the enclave samples first,
        or are given as ``enclave_idx`` (N, s) and ``root_idx`` (n_root,)
        ids into the flattened client data.  No plaintext copy of the
        samples is kept."""
        dev = resolve_device(device)
        data = data.to(dev)
        if generator is None and (enclave_idx is None or root_idx is None):
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        server = SecureServer(device=dev)
        gx, gy = data.enclave_samples(cfg.sample_frac, generator,
                                      idx=enclave_idx)
        for j in range(data.n_clients):
            server.ingest_samples(j, gx[j], gy[j])
        del gx, gy
        flat_x = data.x.reshape((-1,) + tuple(data.x.shape[2:]))
        flat_y = data.y.reshape(-1)
        n_root = max(1, int(cfg.root_frac * flat_y.shape[0]))
        if root_idx is None:
            root_idx = torch.randperm(flat_y.shape[0], generator=generator,
                                      device=generator.device)[:n_root]
        elif tuple(root_idx.shape) != (n_root,):
            raise ValueError(f"root_idx must be ({n_root},), got "
                             f"{tuple(root_idx.shape)}")
        root_idx = root_idx.to(dev)
        return cls(model=model, data=data, test_x=test_x.to(dev),
                   test_y=test_y.to(dev),
                   byz_mask=make_byzantine_mask(data.n_clients, cfg.f,
                                                device=dev),
                   server=server, root_x=flat_x[root_idx],
                   root_y=flat_y[root_idx])


def make_round_body(model: SmallModel, fed: Federation, cfg: FLConfig):
    """Build ``body(params, lr, generator=None, *, batch_idx=None,
    sel=None, noise=None, resample_ids=None) -> (new_params, logs)``: one
    round of Steps 2-5.

    The round's random draws come from ``generator`` in this order: the
    (N, E·m) minibatch indices, the participating subset (only when
    participation < 1), the gaussian attack noise and, last, the
    resampling rule's groups.  Each can be given explicitly instead:
    ``batch_idx`` (N, E·m), ``sel`` (C,) client ids, ``noise`` (C, D)
    standard normal, ``resample_ids`` (C, s_R) client ids."""
    E, m = cfg.local_steps, cfg.batch_size
    acfg = cfg.attack
    N, C = cfg.n_clients, cfg.n_selected
    n_classes = fed.data.n_classes
    entry = get_aggregator(cfg.aggregator)
    dev = fed.device
    if entry.needs_guides:
        fed.server.guide_batches()           # unseal once, before round 1

    def grad_fn(params, batch):
        return model.grad(params, batch, cfg.l2)

    def body(params, lr, generator=None, *, batch_idx=None, sel=None,
             noise=None, resample_ids=None):
        xb, yb = fed.data.minibatch(E * m, generator, idx=batch_idx)
        xb = xb.reshape((N, E, m) + tuple(xb.shape[2:]))
        yb = yb.reshape(N, E, m)
        # Step 2 preamble: the server selects the participating subset S^i
        if sel is None:
            sel = torch.randperm(N, generator=generator, device=dev)[:C] \
                if C < N else torch.arange(N, device=dev)
        sel = sel.to(dev)
        xb, yb = xb[sel], yb[sel]
        byz = fed.byz_mask[sel]

        # ---- data-level attacks ----
        if acfg.kind == "label_flip":
            yb = torch.where(byz[:, None, None], flip_labels(yb, n_classes),
                             yb)
        elif acfg.kind == "backdoor":
            xp, yp = poison_backdoor(
                xb.reshape((C, E * m) + tuple(xb.shape[3:])),
                yb.reshape(C, E * m), acfg)
            bsel = byz.reshape((-1,) + (1,) * (xb.dim() - 1))
            xb = torch.where(bsel, xp.reshape(xb.shape), xb)
            yb = torch.where(byz[:, None, None], yp.reshape(yb.shape), yb)
        logs = {"byz": byz, "sel": sel}

        # ---- Step 2: local SGD, every selected client in one pass ----
        start = {k: v.unsqueeze(0).expand((C,) + tuple(v.shape))
                 for k, v in params.items()}
        theta = start
        for e in range(E):
            g = grad_fn(theta, (xb[:, e], yb[:, e]))
            theta = {k: theta[k] - lr * g[k] for k in theta}
        U, unravel = flatten_updates({k: start[k] - theta[k] for k in start})

        # ---- update-level attacks ----
        if acfg.kind in UPDATE_ATTACKS or acfg.kind == "backdoor":
            U_att = attack_update(U, acfg.kind, acfg, generator, noise=noise)
            U = torch.where(byz[:, None], U_att, U)

        # ---- Steps 3-5: SecureServer (guides / root -> registry) ----
        G = fed.server.compute_guides(params, grad_fn, lr, E, select=sel) \
            if entry.needs_guides else None
        root = fed.server.compute_root_update(
            params, grad_fn, lr, E, fed.root_x, fed.root_y) \
            if entry.needs_root else None
        ctx = AggregationContext(
            f=cfg.f, dfl=cfg.dfl, byz_mask=byz, guides=G, root_update=root,
            resample_s=cfg.resample_s, generator=generator,
            resample_ids=resample_ids)
        delta, agg_logs = fed.server.aggregate(cfg.aggregator, U, ctx)
        logs.update(agg_logs)
        step = unravel(delta)
        return {k: params[k] - step[k] for k in params}, logs

    return body


def _to_host(v: torch.Tensor):
    v = v.detach().cpu()
    return v.item() if v.dim() == 0 else v.numpy()


def run_federated_training(model: SmallModel, fed: Federation, cfg: FLConfig,
                           lr_schedule: Callable, log_every: int = 0,
                           generator: Optional[torch.Generator] = None
                           ) -> Dict:
    """Run ``cfg.rounds`` rounds on the federation's device; returns the
    metric history (keys ``round``, ``acc``, ``mask_tpr``, ``mask_fpr``,
    ``c1c2``, ``final_acc``, ``params``).  The round draws come from
    ``generator`` (default: seeded from ``cfg.seed`` on the device); the
    initial params from a generator seeded with ``cfg.seed + 1``."""
    dev = fed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = model.init(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                        dev)
    body = make_round_body(model, fed, cfg)
    eval_fn = make_eval_fn(model, fed, cfg)
    history = {"round": [], "acc": [], "mask_tpr": [], "mask_fpr": [],
               "c1c2": []}
    with torch.no_grad():
        for i in range(1, cfg.rounds + 1):
            params, logs = body(params, lr_schedule(i), generator)
            if i % cfg.eval_every == 0 or i == cfg.rounds:
                metrics = {k: _to_host(v)
                           for k, v in eval_fn(params, logs).items()}
                history["round"].append(i)
                for k, v in metrics.items():
                    history.setdefault(k, []).append(v)
                if log_every and i % log_every == 0:
                    print(f"  round {i:5d} acc={metrics['acc']:.4f}")
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    history["params"] = params
    return history
