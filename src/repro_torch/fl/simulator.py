"""Federated-learning simulator — Algorithm 1 at simulator scale, in
PyTorch, as an eager per-round loop.

Each round (``make_round_body``): clients run E local SGD steps on fresh
minibatches, ``client_chunk`` clients at a time in one batched pass (all
at once by default); Byzantine clients corrupt their data (label flip,
backdoor) or their updates (gaussian, sign flip, same value, scaling);
the SecureServer computes the guiding updates from the unsealed enclave
samples (DiverseFL) or the root update from its root set (FLTrust) and
hands Steps 4-5 to the aggregator registry, whose weighted-mean rules run
on the CUDA kernels on the card.

With ``streaming=True`` and an associative rule, Steps 2-5 run one
``client_chunk`` block at a time and each block folds into an O(D) state
(``fl/streaming.py``): no (C, D) update or guide matrix exists.  With a
lossy ``compression`` codec (``fl/compression.py``) every selected
client sends ``enc(u + resid)`` and keeps the error in a per-client
residual (error feedback); the round then carries ``(params, resid)``.

Nothing inside a round waits on the card: the metrics leave the device
only at eval points.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, Optional

import torch

from ..core.aggregators import flatten_updates
from ..core.attacks import (UPDATE_ATTACKS, AttackConfig, attack_update,
                            flip_labels, make_byzantine_mask, poison_backdoor)
from ..core.diversefl import DiverseFLConfig
from ..data.pipeline import FederatedData
from ..device import DeviceLike, resolve_device
from .chunking import chunked_vmap
from .compression import available_codecs, encode_with_feedback, get_codec
from .metrics import (BackdoorEval, comm_stats, make_backdoor_eval,
                      make_eval_fn)
from .server import AggregationContext, SecureServer, get_aggregator
from .small_models import SmallModel
from .streaming import fallback_reason, get_streaming, stream_aggregate

logger = logging.getLogger(__name__)


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
    client_chunk: Optional[int] = None   # clients in flight at once
    streaming: bool = False              # fold each chunk into an O(D)
    #                                      state; non-associative rules
    #                                      fall back to the dense path
    stream_shards: Optional[int] = None  # streaming fold groups, merged
    #                                      by the canonical tree (per pod
    #                                      when pods > 1); None = 1
    pods: Optional[int] = None           # two-tier streaming fold: P pod
    #                                      groups tree-merged; None = 1
    compression: str = "f32"             # client→server codec: "f32" is
    #                                      lossless, "bf16"/"int8" carry
    #                                      error feedback
    eval_every: int = 10
    seed: int = 0

    def __post_init__(self):
        get_aggregator(self.aggregator)   # unknown rule -> named ValueError
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{self.participation!r}")
        for name, what in (("client_chunk", "clients in flight at once"),
                           ("stream_shards", "forced fold groups"),
                           ("pods", "forced two-tier pod count")):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v < 1):
                raise ValueError(f"{name} must be None or a positive int "
                                 f"({what}), got {v!r}")
        if self.pods is not None and self.pods > 1:
            if not self.streaming:
                raise ValueError(
                    f"pods={self.pods} requires streaming=True: the two-tier "
                    f"aggregation is an association of the streaming fold; "
                    f"the dense (C, D) path has no pod tiers and would "
                    f"silently ignore the knob")
            if self.client_chunk is None:
                raise ValueError(
                    f"pods={self.pods} requires client_chunk: without "
                    f"chunking the round is a single block and there is "
                    f"nothing to partition across pods")
            k = -(-self.n_selected // min(self.client_chunk,
                                          self.n_selected))
            if self.pods > k or k % self.pods:
                raise ValueError(
                    f"pods={self.pods} cannot tile the padded block count "
                    f"{k} (= ceil(n_selected {self.n_selected} / "
                    f"client_chunk {self.client_chunk})); pick a "
                    f"client_chunk so the blocks divide evenly across pods")
        if self.compression not in available_codecs():
            raise ValueError(
                f"compression={self.compression!r} is not a registered "
                f"codec; available: {available_codecs()} "
                f"(fl/compression.py)")

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
    """Build ``body(carry, lr, generator=None, *, batch_idx=None, sel=None,
    noise=None, resample_ids=None) -> (new_carry, logs)``: one round of
    Steps 2-5.  The carry is the params, or ``(params, resid)`` under a
    lossy codec, ``resid`` the (N, D) fp32 error-feedback residuals;
    ``resid`` is updated in place (a copy per round would double the
    largest tensor of the run) and returned.

    The round's random draws come from ``generator`` in this order: the
    (N, E·m) minibatch indices, the participating subset (only when
    participation < 1), the gaussian attack noise and, last, the
    resampling rule's groups.  The noise is drawn one ``client_chunk``
    block of rows at a time (one (C, D) draw without chunking), on the
    dense and the streaming path alike, so both draw the same numbers.
    Each draw can be given explicitly instead: ``batch_idx`` (N, E·m),
    ``sel`` (C,) client ids, ``noise`` (C, D) standard normal,
    ``resample_ids`` (C, s_R) client ids.

    The body exposes ``streaming`` (the rule streams), ``streaming_fallback``
    (why it does not, when streaming was asked for), ``lossy`` and
    ``codec``."""
    E, m = cfg.local_steps, cfg.batch_size
    acfg = cfg.attack
    N, C = cfg.n_clients, cfg.n_selected
    chunk = cfg.client_chunk
    n_classes = fed.data.n_classes
    entry = get_aggregator(cfg.aggregator)
    codec = get_codec(cfg.compression)
    lossy = not codec.lossless
    wire = codec if lossy else None        # what the server side decodes
    update_attack = acfg.kind in UPDATE_ATTACKS or acfg.kind == "backdoor"
    dev = fed.device
    stream_entry, streaming_fallback = None, None
    if cfg.streaming:
        stream_entry = get_streaming(cfg.aggregator)
        if stream_entry is None:
            streaming_fallback = fallback_reason(cfg.aggregator)
            logger.warning(
                "FLConfig.streaming=True but aggregator %r cannot stream "
                "(%s); falling back to the dense (C, D) aggregation path",
                cfg.aggregator, streaming_fallback)
    if entry.needs_guides:
        fed.server.guide_batches()           # unseal once, before round 1

    def grad_fn(params, batch):
        return model.grad(params, batch, cfg.l2)

    def client_update(params, xs, ys, lr):
        """E local SGD steps of c clients at once: xs (c, E, m, ...) ->
        the client-batched update dict θ - θ_E."""
        c = xs.shape[0]
        start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                 for k, v in params.items()}
        theta = start
        for e in range(E):
            g = grad_fn(theta, (xs[:, e], ys[:, e]))
            theta = {k: theta[k] - lr * g[k] for k in theta}
        return {k: start[k] - theta[k] for k in start}

    def apply_update_attacks(U, byz_rows, noise_rows):
        """One per-row attack definition for the dense (C, D) matrix and
        the streaming (chunk, D) blocks."""
        U_att = attack_update(U, acfg.kind, acfg, noise=noise_rows)
        return torch.where(byz_rows[:, None], U_att, U)

    def draw_noise(generator, rows, d):
        return torch.randn((rows, d), generator=generator, device=dev)

    def body(carry, lr, generator=None, *, batch_idx=None, sel=None,
             noise=None, resample_ids=None):
        params, resid = carry if lossy else (carry, None)
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
        root = fed.server.compute_root_update(
            params, grad_fn, lr, E, fed.root_x, fed.root_y) \
            if entry.needs_root else None
        gaussian = acfg.kind == "gaussian"

        if stream_entry is not None:
            # ---- Steps 2-5, streaming: fold blocks into an O(D) state ----
            ctx = AggregationContext(
                f=cfg.f, dfl=cfg.dfl, byz_mask=byz, root_update=root,
                codec=wire, stream_shards=cfg.stream_shards,
                stream_pods=cfg.pods)
            rule = fed.server.streaming_aggregator(cfg.aggregator, ctx)
            _, unravel = flatten_updates(
                {k: v.unsqueeze(0) for k, v in params.items()})
            d = sum(v.numel() for v in params.values())

            def block_fn(blk, valid):
                xs, ys, byz_b, sel_b, noise_b = blk
                U_blk, _ = flatten_updates(client_update(params, xs, ys, lr))
                if update_attack:
                    if gaussian and noise_b is None:
                        noise_b = draw_noise(generator, U_blk.shape[0], d)
                    U_blk = apply_update_attacks(U_blk, byz_b, noise_b)
                ctx_blk = {"byz": byz_b}
                if entry.needs_guides:
                    ctx_blk["guide"] = fed.server.compute_guides(
                        params, grad_fn, lr, E, select=sel_b, codec=wire)
                if lossy:
                    # the client boundary: only the encoded dict enters
                    # the fold; the new residual rows ride out beside it
                    enc, _, new_resid = encode_with_feedback(
                        codec, U_blk, resid[sel_b])
                    return enc, ctx_blk, new_resid
                return U_blk, ctx_blk

            out = stream_aggregate(
                rule, block_fn, (xb, yb, byz, sel, noise), chunk, d=d,
                shards=cfg.stream_shards, pods=cfg.pods, block_extra=lossy)
            delta, agg_logs, client_logs = out[:3]
            if lossy:
                resid.index_copy_(0, sel, out[3])
            logs.update(client_logs)
        else:
            # ---- Step 2: local SGD, client_chunk clients at a time ----
            updates = chunked_vmap(
                lambda xs, ys: client_update(params, xs, ys, lr), (xb, yb),
                chunk)
            U, unravel = flatten_updates(updates)

            # ---- update-level attacks ----
            if update_attack:
                if gaussian and noise is None:
                    rows = C if chunk is None or chunk >= C else chunk
                    noise = torch.cat([draw_noise(generator, rows, U.shape[1])
                                       for _ in range(-(-C // rows))])[:C]
                U = apply_update_attacks(U, byz, noise)
            if lossy:
                # the registry rules receive the decoded updates: the bits
                # the server recovers from the wire
                _, U, new_resid = encode_with_feedback(codec, U, resid[sel])
                resid.index_copy_(0, sel, new_resid)

            # ---- Steps 3-5: SecureServer (guides / root -> registry) ----
            G = fed.server.compute_guides(
                params, grad_fn, lr, E, select=sel, client_chunk=chunk,
                codec=wire) if entry.needs_guides else None
            ctx = AggregationContext(
                f=cfg.f, dfl=cfg.dfl, byz_mask=byz, guides=G,
                root_update=root, resample_s=cfg.resample_s,
                generator=generator, resample_ids=resample_ids)
            delta, agg_logs = fed.server.aggregate(cfg.aggregator, U, ctx)
        logs.update(agg_logs)
        step = unravel(delta)
        new_params = {k: params[k] - step[k] for k in params}
        return ((new_params, resid) if lossy else new_params), logs

    body.streaming = stream_entry is not None
    body.streaming_fallback = streaming_fallback
    body.lossy = lossy
    body.codec = codec
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
    ``c1c2``, ``final_acc``, ``params``, ``streaming_fallback`` and the
    per-round wire traffic of :func:`~repro_torch.fl.metrics.comm_stats`).
    The round draws come from ``generator`` (default: seeded from
    ``cfg.seed`` on the device); the initial params from a generator
    seeded with ``cfg.seed + 1``.  Under a lossy codec the error-feedback
    residuals start at zero."""
    dev = fed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = model.init(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                        dev)
    d = sum(v.numel() for v in params.values())
    body = make_round_body(model, fed, cfg)
    eval_fn = make_eval_fn(model, fed, cfg)
    carry = (params, torch.zeros((cfg.n_clients, d), dtype=torch.float32,
                                 device=dev)) if body.lossy else params
    history = {"round": [], "acc": [], "mask_tpr": [], "mask_fpr": [],
               "c1c2": []}
    with torch.no_grad():
        for i in range(1, cfg.rounds + 1):
            carry, logs = body(carry, lr_schedule(i), generator)
            params = carry[0] if body.lossy else carry
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
    history["streaming_fallback"] = body.streaming_fallback
    history.update(comm_stats(cfg, d))
    return history
