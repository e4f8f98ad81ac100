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
On a client x model mesh whose model axis is ms > 1 the params are the
rank's tiles (``sharding.place_params``) and every client's update is
computed split over the model group; each rank folds row ``s`` of the
blocked (ms, L) layout (``sharding/api.py``), built from its tiles with
no collective, and its carry is that row's too: the (N, L) residual
columns, encoded in the codec's groups along L, and the (B, L) row of
the staleness slab.  The round's delta row goes straight back into the
tiles.

Training runs through the round engine (``fl/engine.RoundEngine``) by
default: the whole run is dispatched without a host read, every eval
point's metrics accumulate in device buffers, and the host syncs once, in
:func:`host_sync`, at the end.  ``RoundEngine(graph=True)`` captures one
round in a CUDA graph and replays it.  ``use_engine=False`` keeps the
per-round loop, which syncs at every eval point; the engine equals it
bitwise.

Async rounds (``FLConfig.fault``, ``cohort_participation``,
``staleness_*``; ``fl/faults.py``) draw a per-round cohort, drop, delay or
corrupt clients, and land stale updates from a bounded buffer in the
carry through the streaming fold's ``extra_state``.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.aggregators import flat_unravel
from ..core.attacks import (UPDATE_ATTACKS, AttackConfig, attack_update,
                            flip_labels, make_byzantine_mask, poison_backdoor)
from ..core.diversefl import DiverseFLConfig, write_update_rows
from ..data.pipeline import FederatedData
from ..device import DeviceLike, resolve_device
from ..kernels import ops as kops
from ..sharding.api import (BlockedLayout, client_split, gather_clients,
                            model_group, model_index, model_shard_count)
from . import telemetry
from .chunking import chunked_rows, tree_leaves, tree_map
from .compression import available_codecs, encode_with_feedback, get_codec
from .faults import (FaultConfig, corrupt_updates, draw_faults,
                     init_async_state, make_cohort_chain,
                     validate_cohort_chain)
from .metrics import (BackdoorEval, comm_stats, make_backdoor_eval,
                      make_eval_fn)
from .server import (KERNEL_AGG_RULES, AggregationContext, SecureServer,
                     available_aggregators, get_aggregator)
from .small_models import SmallModel
from .streaming import (fallback_reason, fold_plan, get_streaming,
                        stream_aggregate)

logger = logging.getLogger(__name__)

# the registered rules' names, as the reference keeps them
AGGREGATORS = available_aggregators()


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """A run's knobs, validated as the reference validates them.

    ``use_kernel_stats`` and ``use_kernel_agg`` are the reference's
    switches onto its Pallas kernels, accepted and refused in the
    reference's combinations; in the port they choose nothing.  The
    tensors' device picks the route (``kernels/ops.py``): on the card the
    statistics and the folds always run the CUDA kernels, whose masked
    mean (``masked_agg.cu``) is bitwise the left fold of the plain path."""
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
    use_kernel_stats: bool = False       # the reference's Pallas routes;
    use_kernel_agg: bool = False         # validated as there, choose nothing
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
    donate: Optional[bool] = None        # the reference's buffer donation;
    #                                      the port has none, so True is
    #                                      refused and None/False are inert
    telemetry: bool = False              # per-round on-device telemetry
    #                                      block, drained at the one host
    #                                      sync; changes no history bit
    fault: FaultConfig = FaultConfig()   # device-malfunction model
    #                                      (fl/faults.py), drawn per round
    cohort_participation: Optional[float] = None
    #                                      a fresh ceil(p·N) cohort every
    #                                      round from the (R, N) cohort
    #                                      chain; None = off
    staleness_buffer: int = 0            # slots of the pending slab in the
    #                                      carry (O(buffer·D)); 0 = late
    #                                      updates expire
    staleness_cap: int = 0               # updates older than this expire
    #                                      instead of buffering (0 = none)
    staleness_discount: float = 1.0      # landing weight per round late
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
        if self.use_kernel_agg and self.aggregator not in KERNEL_AGG_RULES:
            raise ValueError(
                f"use_kernel_agg=True requires a masked/weighted-mean "
                f"family aggregator {KERNEL_AGG_RULES}; {self.aggregator!r} "
                f"never routes through the fused masked-agg kernel, so the "
                f"flag would be silently ignored")
        if (self.streaming and self.use_kernel_stats
                and not self.use_kernel_agg
                and self.aggregator == "diversefl"):
            raise ValueError(
                "use_kernel_stats=True is unreachable on the streaming "
                "row-fold path (per-client statistics are computed inline "
                "during the fold); combine it with use_kernel_agg=True for "
                "the fused per-block kernel path, or drop the flag")
        if self.donate:
            raise ValueError(
                "donate=True: the port has no buffer donation; every round "
                "allocates its new carry and leaves the caller's tensors "
                "untouched.  Use donate=None or False")
        if self.compression not in available_codecs():
            raise ValueError(
                f"compression={self.compression!r} is not a registered "
                f"codec; available: {available_codecs()} "
                f"(fl/compression.py)")
        if (not get_codec(self.compression).lossless
                and self.use_kernel_agg and not self.streaming):
            raise ValueError(
                f"compression={self.compression!r} with use_kernel_agg=True "
                f"requires streaming=True: the fused dequantize-and-fold "
                f"kernel IS the streaming block fold — the dense path "
                f"decodes updates before aggregation, so the kernel flag "
                f"would silently buy no fusion (DESIGN.md §10)")
        # --- async knobs ------------------------------------------------
        if not isinstance(self.fault, FaultConfig):
            raise ValueError(
                f"fault must be a fl.faults.FaultConfig, got "
                f"{type(self.fault).__name__}")
        if self.cohort_participation is not None:
            p = self.cohort_participation
            if isinstance(p, bool) or not isinstance(p, (int, float)) \
                    or not (0.0 < float(p) <= 1.0):
                raise ValueError(
                    f"cohort_participation must be None (static cohort) or "
                    f"a fraction in (0, 1]: a cohort of zero clients every "
                    f"round is degenerate (0/0 weighted mean); got {p!r}")
        for name in ("staleness_buffer", "staleness_cap"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"{name} must be a non-negative int (rounds/slots), "
                    f"got {v!r}")
        if not (0.0 < float(self.staleness_discount) <= 1.0):
            raise ValueError(
                f"staleness_discount must be in (0, 1] (landing weight "
                f"multiplier per round of staleness), got "
                f"{self.staleness_discount!r}")
        if self.async_rounds:
            if self.participation != 1.0:
                raise ValueError(
                    f"async rounds (fault/cohort/staleness knobs) replace "
                    f"the static participation selection with the per-round "
                    f"cohort chain: set participation=1.0 and use "
                    f"cohort_participation={self.participation} for "
                    f"resampled partial participation")
            if not self.streaming or get_streaming(self.aggregator) is None:
                why = ("streaming=False" if not self.streaming else
                       f"aggregator {self.aggregator!r} has no streaming "
                       f"rule ({fallback_reason(self.aggregator)})")
                raise ValueError(
                    f"async rounds fold per-round cohorts, faulty clients "
                    f"and landed stale updates through the streaming "
                    f"AggState monoid's weight channel, but {why}: the "
                    f"dense path has no per-client weight channel to carry "
                    f"the cohort/staleness masks")
            if not get_codec(self.compression).lossless:
                raise ValueError(
                    f"async rounds cannot compose with the lossy "
                    f"compression={self.compression!r}: error-feedback "
                    f"residuals assume every client transmits every round, "
                    f"but cohort resampling and dropout make transmission "
                    f"intermittent, so the residual would go stale.  Use "
                    f"compression='f32'")

    @property
    def async_rounds(self) -> bool:
        """True when any async knob engages the per-round cohort, fault or
        staleness machinery; False leaves the round exactly the
        synchronous one."""
        return (self.fault.kind != "none"
                or self.cohort_participation is not None
                or self.staleness_buffer > 0)

    @property
    def n_selected(self) -> int:
        return max(1, min(self.n_clients,
                          math.ceil(self.participation * self.n_clients)))

    def validate_model_sharding(self, d: int, model_shards: int,
                                streaming_fallback: Optional[str] = None,
                                leaf_sizes: Optional[tuple] = None):
        """Named errors, in the reference's words, for knobs that cannot
        compose with a model-sharded run.  The engine checks them on its
        first run, once the flat dim ``d`` (and ``leaf_sizes``) of the
        params is known.  ``model_shards`` is the mesh's model-axis size
        (``sharding.model_shard_count``); ``streaming_fallback`` the
        engine's fallback reason, so a streaming config whose rule fell
        back to the dense path fails here too.  A no-op when
        ``model_shards <= 1``."""
        if model_shards <= 1:
            return
        if not self.streaming or streaming_fallback is not None:
            why = (f"aggregator {self.aggregator!r} cannot stream "
                   f"({streaming_fallback})" if streaming_fallback
                   else "streaming=False")
            raise ValueError(
                f"model-sharded run (model_shards={model_shards}) requires "
                f"the streaming fold, but {why}: the dense fallback "
                f"materializes the full (n_selected={self.n_selected}, "
                f"D={d}) update matrix — at tensor-parallel model sizes "
                f"that is exactly the O(N·D) term the streaming AggState "
                f"exists to remove (DESIGN.md §6, §12).  Use streaming=True "
                f"with a streaming-capable aggregator "
                f"(fl/streaming.streaming_rules())")
        if self.use_kernel_agg or self.use_kernel_stats:
            flag = "use_kernel_agg" if self.use_kernel_agg \
                else "use_kernel_stats"
            raise ValueError(
                f"{flag}=True cannot compose with a model-sharded run "
                f"(model_shards={model_shards}): the Pallas fold/stats "
                f"kernels are single-device programs over an unsharded "
                f"(chunk, D) block — under GSPMD they would force a "
                f"cross-model-axis gather of the very matrix the sharding "
                f"splits.  Drop the kernel flags (the in-fold axis=-1 "
                f"reductions shard for free)")
        codec = get_codec(self.compression)
        if not codec.lossless and leaf_sizes is not None:
            bad = [s for s in leaf_sizes if s % model_shards]
            if bad:
                raise ValueError(
                    f"compression={self.compression!r} (lossy) on a "
                    f"model-sharded run needs every parameter tensor to "
                    f"tile the model axis — the blocked (ms, L) layout "
                    f"must be pad-free so the (N, D) error-feedback "
                    f"residual plane reshapes losslessly onto the update "
                    f"blocks — but {len(bad)} leaf(s) (e.g. size "
                    f"{bad[0]}) are not multiples of model_shards="
                    f"{model_shards} (DESIGN.md §12)")
        if codec.qblock is not None:
            if d % model_shards:
                raise ValueError(
                    f"compression={self.compression!r} on a model-sharded "
                    f"run needs the flat dim to tile the model axis: "
                    f"D={d} % model_shards={model_shards} != 0, so the "
                    f"per-block scale groups would straddle shard "
                    f"boundaries")
            local = d // model_shards
            if local % codec.qblock:
                raise ValueError(
                    f"compression={self.compression!r} quantizes in "
                    f"QBLOCK={codec.qblock} groups along the flat dim, but "
                    f"the local model shard D/model_shards = {d}/"
                    f"{model_shards} = {local} is not a multiple of "
                    f"{codec.qblock}: wire blocks would straddle shard "
                    f"boundaries and every encode/decode would pay a "
                    f"cross-model-axis reshard.  Pick a model_shards (or "
                    f"model size) with QBLOCK | D/model_shards")


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


# the cohort chain's generator is seeded apart from the training draws
# (both start from cfg.seed), as the reference folds its cohort key away
# from the training key
COHORT_SEED_OFFSET = 0x0C0407


def make_scenario(cfg: FLConfig, fed: Optional["Federation"] = None,
                  byz_mask=None, cohort=None, device: DeviceLike = None
                  ) -> Dict[str, torch.Tensor]:
    """The round's per-run operands as device tensors: the attack
    magnitudes ``sigma``/``scale`` (0-d fp32) and the (N,) Byzantine mask
    ``byz``, everything about a run that changes its numbers and not its
    structure, so one engine (and one CUDA graph) serves every scenario.

    ``byz_mask`` overrides; else ``fed.byz_mask``; else the deterministic
    ``make_byzantine_mask(n_clients, f)``.  With
    ``cfg.cohort_participation`` set the scenario also carries ``cohort``,
    the (R, N) cohort chain drawn from a generator seeded with
    ``cfg.seed + COHORT_SEED_OFFSET``; an explicit ``cohort`` is
    validated (``DegenerateCohortError``) and used instead.  Built from
    ``fed`` it copies nothing from the host."""
    dev = fed.device if fed is not None and device is None \
        else resolve_device(device)
    if byz_mask is not None:
        byz = torch.as_tensor(byz_mask, dtype=torch.bool).to(dev)
    elif fed is not None:
        byz = fed.byz_mask.to(dev)
    else:
        byz = make_byzantine_mask(cfg.n_clients, cfg.f, device=dev)
    scen = {"sigma": torch.full((), cfg.attack.sigma, dtype=torch.float32,
                                device=dev),
            "scale": torch.full((), cfg.attack.scale, dtype=torch.float32,
                                device=dev),
            "byz": byz}
    if cohort is not None:
        validate_cohort_chain(cohort, cfg.n_clients, cfg.rounds)
        scen["cohort"] = torch.as_tensor(cohort, dtype=torch.bool).to(dev)
    elif cfg.cohort_participation is not None:
        gen = torch.Generator(device=dev).manual_seed(
            cfg.seed + COHORT_SEED_OFFSET)
        scen["cohort"] = make_cohort_chain(cfg.n_clients, cfg.rounds,
                                           cfg.cohort_participation, gen)
    return scen


def make_round_body(model: SmallModel, fed: Federation, cfg: FLConfig):
    """Build ``body(carry, lr, generator=None, *, batch_idx=None, sel=None,
    noise=None, resample_ids=None, fault_rows=None, slab_noise=None,
    scen=None, batch=None, like=None) -> (new_carry, logs)``: one round of
    Steps 2-5.  The carry
    is the params; ``(params, resid)`` under a lossy codec, ``resid`` the
    (N, D) fp32 error-feedback residuals, updated in place (a copy per
    round would double the largest tensor of the run) and returned; or
    ``(params, astate)`` in async rounds, ``astate`` the
    ``fl/faults.init_async_state`` dict.  Under an active mesh whose model
    axis is ms > 1 the rank's share replaces D by the blocked layout's
    row width L: ``resid`` is (N, L) (lossy codecs need pad-free leaves,
    so ms·L == D) and the slab ``astate["u"]`` (B, L); the rest of
    ``astate`` is whole on every rank.  There the params are the rank's
    tiles and ``like`` holds the whole params' shapes (meta tensors; the
    round engine passes them).  ``lr`` is a number or a 0-d fp32
    tensor (the same bits).  ``scen`` holds the run's operands
    (:func:`make_scenario`; default: this federation's).

    The round's random draws come from ``generator`` in this order: the
    (N, E·m) minibatch indices; the participating subset (only when
    participation < 1); the fault rows (only in async rounds with a fault
    rate); the gaussian attack noise; the straggler slab's gaussian noise
    (only with stragglers buffered); and, last, the resampling rule's
    groups.  The noise is drawn one ``client_chunk`` block of rows at a
    time (one (C, D) draw without chunking), on the dense and the
    streaming path alike, so both draw the same numbers.  The cohort chain
    is not a round draw: it comes with the scenario.  Each draw can be
    given explicitly instead: ``batch_idx`` (N, E·m) (or the gathered
    ``batch`` stacks (N, E·m, ...), (N, E·m)), ``sel`` (C,) client
    ids, ``fault_rows`` (N,) bool, ``noise`` (C, D) standard normal,
    ``slab_noise`` (B, D) (whole on a model axis too: the attack hits the
    whole update before the cut), ``resample_ids`` (C, s_R) client ids.

    On a mesh of R > 1 data ranks the round splits where
    ``sharding.client_split`` says so (``body.client_rows()``, asked
    under the active mesh): each rank builds and computes only its rows
    ``[lo, hi)`` of the C selected clients.  It draws every round draw
    whole, as the one-process round does (the noise block by block,
    keeping its own rows), so every rank's generator stays in step.  On
    the dense path it runs its rows' data attacks, local SGD, update
    attacks, codec and guides and the (C/R, 3) statistics of Step 4; the
    statistics, the update rows and, under a lossy codec, the new
    residual rows are gathered in client order, so Steps 4-5 see exactly
    the one-process (C, D) update matrix and the round is the one-process
    round bit for bit.  The guide matrix never leaves its rank.  On the
    streaming path the rank's rows are exactly the blocks it folds.
    ``batch`` may then hold the rank's rows only (the round engine's
    segment stacks).  Elsewhere the round runs whole on every rank, with
    no collective.

    No step of the round reads a device value on the host, so a run
    dispatches without waiting on the card and one round can be captured
    in a CUDA graph.

    The round enters the phases of ``telemetry.PHASES`` in order
    (``telemetry.phase``: a mark in the device's stream, a host range
    under the profiler): ``local_sgd`` first (the selection, the
    minibatch gather, the data attacks and, dense, Step 2's local SGD),
    then on the dense path ``update_rows`` (flattening, update attacks,
    the codec and the residual write), ``guides`` (the guides, FLTrust's
    root update) and ``aggregate`` (Steps 4-5 through the param apply).
    A streaming round enters the four once per fold block (the root
    update, ``guides``, before the first; the block's fold follows its
    ``aggregate`` mark), and the landed stragglers' guides as ``guides``.

    Every client's update row and every guide's is written once, in place,
    by the client step (``core.diversefl.write_update_rows``: the model's
    data-loss gradient, then the last SGD step with its ridge term and the
    difference from the start in one pass, the CUDA kernel
    ``client_step_rows`` on the card): the dense path into the round's
    (C, D) matrices block by block, the streaming path into each block's
    (chunk, D) rows, the straggler slab into its (B, D) rows.

    The body exposes ``streaming`` (the rule streams), ``streaming_fallback``
    (why it does not, when streaming was asked for), ``lossy``, ``codec``,
    ``async_mode`` and ``client_rows``."""
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
    gaussian = acfg.kind == "gaussian"
    dev = fed.device
    # async rounds: everything below is gated on these constants, so a
    # synchronous config runs exactly the synchronous round
    async_mode = cfg.async_rounds
    fcfg = cfg.fault
    straggler = async_mode and fcfg.kind == "straggler"
    B = cfg.staleness_buffer if async_mode else 0
    cap = cfg.staleness_cap
    # stragglers expire wholesale when there is nowhere to land them or
    # the cap forbids their age
    expire_all = straggler and (B == 0 or (cap > 0 and fcfg.delay > cap))
    # every buffered update lands at age == delay: one discount factor
    discount_w = float(cfg.staleness_discount) ** fcfg.delay \
        if async_mode else 1.0
    default_scen = make_scenario(cfg, fed)
    stream_entry, streaming_fallback = None, None
    if cfg.streaming:
        stream_entry = get_streaming(cfg.aggregator)
        if stream_entry is None:
            streaming_fallback = fallback_reason(cfg.aggregator)
            logger.warning(
                "FLConfig.streaming=True but aggregator %r cannot stream "
                "(%s); falling back to the dense (C, D) aggregation path",
                cfg.aggregator, streaming_fallback)
            telemetry.event("streaming_fallback", aggregator=cfg.aggregator,
                            reason=streaming_fallback)
    if entry.needs_guides:
        fed.server.guide_batches()           # unseal once, before round 1
    l2 = cfg.l2

    def grad_fn(params, batch):
        """The data loss's gradient: the ridge enters the step itself."""
        return model.grad(params, batch, 0.0)

    def client_update(params, xs, ys, lr, out, row0=0, rows=None):
        """E local SGD steps of c clients at once from the shared params:
        xs (c, E, m, ...); the update rows θ - θ_E, fp32, each step
        rounded once to the params' dtype, written into rows ``row0 ..``
        of ``out`` (the first ``rows`` clients; default all)."""
        c = xs.shape[0]
        start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                 for k, v in params.items()}
        write_update_rows(out, start,
                          [(xs[:, e], ys[:, e]) for e in range(E)], grad_fn,
                          lr, l2, clients=c, row0=row0, rows=rows)
        return out

    def update_matrix(params, rows):
        """An uninitialised (rows, D) fp32 matrix for the rows of the
        params' (or tiles') flat layout."""
        return torch.empty((rows, sum(v.numel() for v in params.values())),
                           dtype=torch.float32, device=dev)

    def apply_update_attacks(U, byz_rows, noise_rows, scen):
        """One per-row attack definition for the dense (C, D) matrix, the
        streaming (chunk, D) blocks and the straggler slab; the
        magnitudes come from the scenario."""
        U_att = attack_update(U, acfg.kind, acfg, noise=noise_rows,
                              sigma=scen["sigma"], scale=scen["scale"])
        return torch.where(byz_rows[:, None], U_att, U)

    def draw_noise(generator, rows, d):
        return torch.randn((rows, d), generator=generator, device=dev)

    def draw_noise_rows(generator, d, split):
        """The (C, d) gaussian attack noise, one ``client_chunk`` block of
        rows at a time; on a split round every block is drawn (the
        generator stays in step) and the rank keeps its rows."""
        rows = C if chunk is None or chunk >= C else chunk
        lo, hi = (0, C) if split is None else split
        keep = []
        for b0 in range(0, C, rows):
            z = draw_noise(generator, rows, d)
            a, e = max(lo, b0), min(hi, b0 + rows)
            if a < e:
                keep.append(z[a - b0:e - b0])
        return torch.cat(keep)

    def apply_delta(params, step):
        """The fp32 delta, one rounding to each param's dtype (the
        identity for fp32 params), as the reference's
        ``(p - d).astype(p.dtype)``."""
        return {k: (params[k] - step[k]).to(params[k].dtype)
                for k in params}

    def client_rows():
        """``(lo, hi)``: the rows of the round's C clients this rank
        computes when the round splits over the active mesh's data ranks
        (``sharding.client_split``); None where it runs whole.  Async
        rounds run whole: the straggler slab refills from any client's
        batch."""
        if async_mode:
            return None
        if stream_entry is None:
            return client_split(C)
        block, _, pods, shards = fold_plan(C, chunk, cfg.stream_shards,
                                           cfg.pods)
        return client_split(C, chunk=block, groups=pods * shards)

    def body(carry, lr, generator=None, *, batch_idx=None, sel=None,
             noise=None, resample_ids=None, fault_rows=None,
             slab_noise=None, scen=None, batch=None, like=None):
        with telemetry.phase("local_sgd", dev):
            astate = resid = None
            if lossy:
                params, resid = carry
            elif async_mode:
                params, astate = carry
            else:
                params = carry
            if scen is None:
                scen = default_scen
            split = client_rows()
            # a batch of fewer than N rows holds this rank's rows of a split
            # round of all N clients
            rank_batch = batch is not None and batch[1].shape[0] != N
            if batch is None:
                idx = fed.data.minibatch_idx(E * m, generator, idx=batch_idx)
            elif rank_batch and (split is None or sel is not None or C < N
                                 or batch[1].shape[0] != split[1] - split[0]):
                raise ValueError(
                    f"batch holds {batch[1].shape[0]} of the {N} clients' "
                    f"rows, but this rank computes rows {split} of the "
                    f"round's {C} selected clients"
                    f"{'' if sel is None else ' (sel given)'}: rank-row "
                    f"stacks need the round's own split of all N clients")
            # Step 2 preamble: the server selects the participating subset S^i
            if sel is None:
                sel = torch.randperm(N, generator=generator, device=dev)[:C] \
                    if C < N else torch.arange(N, device=dev)
            sel = sel.to(dev)
            byz = scen["byz"][sel]
            # the selected clients this rank computes: all of them, or its
            # rows of a split round
            rsel, rbyz, rnoise = sel, byz, noise
            if split is not None:
                lo, hi = split
                rsel, rbyz = sel[lo:hi], byz[lo:hi]
                rnoise = None if noise is None else noise[lo:hi]
            if batch is None:
                xb, yb = fed.data.client_minibatch(idx, rsel)
            elif rank_batch:
                xb, yb = batch
            else:
                xb, yb = batch[0][rsel], batch[1][rsel]
            n_r = int(rsel.shape[0])
            xb = xb.reshape((n_r, E, m) + tuple(xb.shape[2:]))
            yb = yb.reshape(n_r, E, m)

            live = strag = None
            if async_mode:
                # participation is 1 here, so sel is arange(N): rows are ids
                if "cohort" in scen:
                    m_r = scen["cohort"].index_select(
                        0, astate["r"].view(1))[0]
                else:
                    m_r = torch.ones((N,), dtype=torch.bool, device=dev)
                if fault_rows is None:
                    fault_rows = draw_faults(N, fcfg, generator, dev)
                fault_rows = fault_rows.to(dev)
                # a dropped or late update never arrives this round: weight 0
                # through the fold's ``live`` channel
                live = m_r & ~fault_rows \
                    if fcfg.kind in ("dropout", "straggler") else m_r
                if straggler:
                    strag = m_r & fault_rows

            # ---- data-level attacks ----
            if acfg.kind == "label_flip":
                yb = torch.where(rbyz[:, None, None],
                                 flip_labels(yb, n_classes), yb)
            elif acfg.kind == "backdoor":
                xp, yp = poison_backdoor(
                    xb.reshape((n_r, E * m) + tuple(xb.shape[3:])),
                    yb.reshape(n_r, E * m), acfg)
                bsel = rbyz.reshape((-1,) + (1,) * (xb.dim() - 1))
                xb = torch.where(bsel, xp.reshape(xb.shape), xb)
                yb = torch.where(rbyz[:, None, None], yp.reshape(yb.shape), yb)
            logs = {"byz": byz, "sel": sel}
            if stream_entry is None:
                # ---- Step 2: local SGD, client_chunk clients at a time,
                # each block's rows written into U in place ----
                U = update_matrix(params, n_r)
                chunked_rows(
                    lambda xs, ys, row0, rows: client_update(
                        params, xs, ys, lr, U, row0, rows), (xb, yb), chunk)

        def root_update():
            """FLTrust's root update, the server's reference update: in
            the guides phase."""
            if not entry.needs_root:
                return None
            with telemetry.phase("guides", dev):
                return fed.server.compute_root_update(
                    params, grad_fn, lr, E, fed.root_x, fed.root_y, l2=l2)

        if stream_entry is not None:
            # ---- Steps 2-5, streaming: fold blocks into an O(D) state ----
            # on a model axis > 1 the params are this rank's tiles and it
            # folds row s of the blocked (ms, L) layout, built from the
            # tiles' updates, guides and root
            ms = model_shard_count()
            layout = None
            if ms > 1:
                if like is None:
                    raise ValueError(
                        "a round on a model axis > 1 takes the rank's tiles "
                        "and like= (the whole params' shapes): run it "
                        "through fl.engine.RoundEngine")
                layout = BlockedLayout(like, ms, batched=False)
            srow = model_index()
            D = layout.D if layout is not None \
                else sum(v.numel() for v in params.values())
            root = root_update()
            if layout is not None and root is not None:
                root = layout.local_rows(root.unsqueeze(0), srow)[0]
            ctx = AggregationContext(
                f=cfg.f, dfl=cfg.dfl, byz_mask=byz, root_update=root,
                codec=wire, stream_shards=cfg.stream_shards,
                stream_pods=cfg.pods)
            rule = fed.server.streaming_aggregator(cfg.aggregator, ctx)
            if layout is None:
                unravel = flat_unravel(params)
                d = D
            else:
                d = layout.L

                def unravel(row):
                    return layout.unravel_local(row, srow, model_group())
            skip_fn = None
            if gaussian and noise is None:
                rows = C if chunk is None or chunk >= C else chunk

                def skip_fn(b):
                    # a block another data rank folds: its noise is drawn
                    # and dropped, so the generator stays in step with
                    # the one-process fold's per-block draws
                    draw_noise(generator, rows, D)

            def block_fn(blk, valid):
                if async_mode:
                    xs, ys, byz_b, sel_b, noise_b, live_b, fault_b = blk
                else:
                    xs, ys, byz_b, sel_b, noise_b = blk
                with telemetry.phase("local_sgd", dev):
                    U_blk = client_update(params, xs, ys, lr,
                                          update_matrix(params, xs.shape[0]))
                with telemetry.phase("update_rows", dev):
                    if update_attack:
                        if gaussian and noise_b is None:
                            noise_b = draw_noise(generator, U_blk.shape[0], D)
                        if gaussian and layout is not None:
                            # drawn at D, as the meshless round draws it
                            noise_b = layout.local_cut(noise_b, srow)
                        U_blk = apply_update_attacks(U_blk, byz_b, noise_b,
                                                     scen)
                    if async_mode and fcfg.kind == "intermittent":
                        # a malfunction at the client boundary, after the
                        # attack: it hits whatever the client transmits
                        U_blk = corrupt_updates(U_blk, fault_b, fcfg)
                    if layout is not None:
                        U_blk = layout.local_rows(U_blk, srow)
                    ctx_blk = {"byz": byz_b}
                    if async_mode:
                        ctx_blk["live"] = live_b
                    if lossy:
                        # the client boundary: only the encoded dict
                        # enters the fold; the new residual rows ride out
                        # beside it.  On a model axis > 1 the row, the
                        # residual and the int8 groups are the rank's
                        # (c, L) columns (QBLOCK | L is validated); the
                        # guides are quantised per tensor before the cut,
                        # so their layout does not matter
                        enc, _, new_resid = encode_with_feedback(
                            codec, U_blk, resid[sel_b])
                if entry.needs_guides:
                    with telemetry.phase("guides", dev):
                        G_blk = fed.server.compute_guides(
                            params, grad_fn, lr, E, select=sel_b,
                            codec=wire, like=like, l2=l2)
                        ctx_blk["guide"] = G_blk if layout is None \
                            else layout.local_rows(G_blk, srow)
                # the fold of the block follows in stream_aggregate
                with telemetry.phase("aggregate", dev):
                    return (enc, ctx_blk, new_resid) if lossy \
                        else (U_blk, ctx_blk)

            # ---- bounded staleness: the buffered updates that land now
            # fold through the same monoid, with guides recomputed at the
            # landing round's params, and merge before finalize
            extra_state = stale_logs = landed = land_cid = None
            if B > 0:
                ttl1 = astate["ttl"] - 1
                landed = astate["on"] & (ttl1 <= 0)
                land_cid = astate["cid"]
                land_ctx = {"byz": scen["byz"][land_cid],
                            # the discount rides the 0/1 valid channel
                            "valid": landed.to(torch.float32) * discount_w}
                if entry.needs_guides:
                    with telemetry.phase("guides", dev):
                        G_land = fed.server.compute_guides(
                            params, grad_fn, lr, E, select=land_cid, l2=l2)
                        land_ctx["guide"] = G_land if layout is None \
                            else layout.local_rows(G_land, srow)
                extra_state, stale_logs = rule.update_block(
                    rule.init(d, dev), astate["u"], land_ctx)

            args = (xb, yb, rbyz, rsel, rnoise)
            if async_mode:
                args = args + (live, fault_rows)
            out = stream_aggregate(
                rule, block_fn, args, chunk, d=d, shards=cfg.stream_shards,
                pods=cfg.pods, block_extra=lossy, extra_state=extra_state,
                skip_fn=skip_fn, clients=C)
            delta, agg_logs, client_logs = out[:3]
            if lossy:
                resid.index_copy_(0, sel, out[3])
            logs.update(client_logs)
            if async_mode:
                account_async(logs, scen, live, landed, land_cid,
                              stale_logs)
                astate = refill_buffer(params, astate, xb, yb, lr, scen,
                                       strag, landed, generator, slab_noise,
                                       D, logs, layout, srow)
            new_params = apply_delta(params, unravel(delta))
        else:
            with telemetry.phase("update_rows", dev):
                unravel = flat_unravel(params)

                # ---- update-level attacks ----
                if update_attack:
                    if gaussian and rnoise is None:
                        rnoise = draw_noise_rows(generator, U.shape[1], split)
                    U = apply_update_attacks(U, rbyz, rnoise, scen)
                if lossy:
                    # the registry rules receive the decoded updates: the
                    # bits the server recovers from the wire
                    _, U, new_resid = encode_with_feedback(codec, U,
                                                           resid[rsel])
                    if split is not None:
                        new_resid = gather_clients(new_resid)
                    resid.index_copy_(0, sel, new_resid)

            # ---- Steps 3-5: SecureServer (guides / root -> registry) ----
            G = None
            if entry.needs_guides:
                with telemetry.phase("guides", dev):
                    G = fed.server.compute_guides(
                        params, grad_fn, lr, E, select=rsel,
                        client_chunk=chunk, codec=wire, l2=l2)
            root = root_update()
            with telemetry.phase("aggregate", dev):
                stats = None
                if split is not None:
                    # a row's statistics depend on that row alone: the
                    # rank computes its rows' and only the (C, 3)
                    # statistics cross the ranks, never the guides.  The
                    # update rows are gathered in client order: the rules
                    # see the one-process matrix
                    if G is not None:
                        stats = gather_clients(kops.similarity_stats(U, G))
                        G = None
                    U = gather_clients(U)
                ctx = AggregationContext(
                    f=cfg.f, dfl=cfg.dfl, byz_mask=byz, guides=G,
                    stats=stats, root_update=root,
                    resample_s=cfg.resample_s, generator=generator,
                    resample_ids=resample_ids)
                delta, agg_logs = fed.server.aggregate(cfg.aggregator, U,
                                                       ctx)
                new_params = apply_delta(params, unravel(delta))
        logs.update(agg_logs)
        if lossy:
            return (new_params, resid), logs
        if async_mode:
            return (new_params, astate), logs
        return new_params, logs

    def refill_buffer(params, astate, xb, yb, lr, scen, strag, landed,
                      generator, slab_noise, D, logs, layout, srow):
        """The round's stragglers take the free slots of the pending slab
        in client order (the overflow expires); landed slots free up.  A
        slot stores only the flat update, recomputed from the round's own
        batch at the round's own params, so the slab stays O(B·D).  On a
        model axis > 1 (``layout``) a slot keeps row ``srow`` of the
        blocked layout, built from the rank's tiles: its (B, D) noise is
        drawn as the meshless round draws it and cut to the tiles.  Writes
        the three staleness counts into ``logs``."""
        i32 = torch.int32
        zero = torch.zeros((), dtype=i32, device=dev)
        buffered, expired = zero, zero
        folded = landed.sum(dtype=i32) if landed is not None else zero
        new = {"r": astate["r"] + 1}
        if expire_all:
            expired = strag.sum(dtype=i32)
        if B > 0:
            on2 = astate["on"] & ~landed
            ttl_keep = (astate["ttl"] - 1).clamp_min(0)
            if straggler and not expire_all:
                ns = strag.sum(dtype=torch.int64)
                ar = torch.arange(N, device=dev)
                order = torch.argsort(torch.where(strag, ar, N + ar))
                free = ~on2
                free_rank = free.to(torch.int64).cumsum(0) - 1
                take = free & (free_rank < ns)
                src = order[free_rank.clamp(0, N - 1)]
                U_s = client_update(params, xb[src], yb[src], lr,
                                    update_matrix(params, B))
                if update_attack:
                    if gaussian and slab_noise is None:
                        slab_noise = draw_noise(generator, B, D)
                    if gaussian and layout is not None:
                        slab_noise = layout.local_cut(slab_noise, srow)
                    U_s = apply_update_attacks(U_s, scen["byz"][src],
                                               slab_noise, scen)
                if layout is not None:
                    U_s = layout.local_rows(U_s, srow)
                new.update(
                    u=torch.where(take[:, None], U_s.to(torch.float32),
                                  astate["u"]),
                    cid=torch.where(take, src, astate["cid"]),
                    ttl=torch.where(take, torch.full_like(ttl_keep,
                                                          fcfg.delay),
                                    ttl_keep),
                    on=on2 | take)
                buffered = take.sum(dtype=i32)
                expired = ns.to(i32) - buffered
            else:
                new.update(u=astate["u"], cid=astate["cid"], ttl=ttl_keep,
                           on=on2)
        logs["stale_buffered"] = buffered
        logs["stale_folded"] = folded
        logs["stale_expired"] = expired
        return new

    def account_async(logs, scen, live, landed, land_cid, stale_logs):
        """Landed slot rows join the per-client logs, so the tag and
        TPR/FPR accounting scores them at their landing round; ``cand``
        marks the rows that took part."""
        cand = live
        if stale_logs is not None:
            for k in list(logs):
                if k in stale_logs:
                    logs[k] = torch.cat([logs[k], stale_logs[k]])
            logs["byz"] = torch.cat([logs["byz"], scen["byz"][land_cid]])
            logs["sel"] = torch.cat([logs["sel"], land_cid])
            cand = torch.cat([live, landed])
        logs["cand"] = cand
        logs["cohort"] = live.sum(dtype=torch.int32)

    body.streaming = stream_entry is not None
    body.streaming_fallback = streaming_fallback
    body.lossy = lossy
    body.codec = codec
    body.async_mode = async_mode
    body.client_rows = client_rows
    return body


# ----------------------------------------------------------------------
# The host side of a run
# ----------------------------------------------------------------------

def _fetch(leaf):
    """One leaf on the host: a Python number for a 0-d tensor, a numpy
    array otherwise (numbers and arrays pass through)."""
    if not torch.is_tensor(leaf):
        return leaf
    v = leaf.detach()
    return v.item() if v.dim() == 0 else v.numpy()


def host_sync(tree):
    """The simulator's one device-to-host point: every value
    ``run_federated_training`` moves off the card flows through here, the
    per-round loop once per eval point, the engine once per run.  Keeping
    one choke point makes the sync count measurable: wrap this function
    with a counter and run under ``torch.cuda.set_sync_debug_mode("error")``,
    which this function alone lifts while it reads.

    Every CUDA leaf is copied into pinned host memory without blocking,
    then the stream is synchronised once (inside the host range
    ``fl.host_sync`` while ``torch.profiler`` records).  With the flight
    recorder on, each call records a ``sync`` event with the bytes moved
    and the fetch's wall time."""
    rec = telemetry.get_recorder()
    leaves = [x for x in tree_leaves(tree) if torch.is_tensor(x)]
    t0 = rec.now() if rec.enabled else 0.0
    cuda = [x for x in leaves if x.is_cuda]
    if cuda:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            staged = {}
            with telemetry.profiled("fl.host_sync"):
                for x in cuda:
                    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    h.copy_(x, non_blocking=True)
                    staged[id(x)] = h
                torch.cuda.current_stream(cuda[0].device).synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        tree = tree_map(lambda x: staged.get(id(x), x)
                        if torch.is_tensor(x) else x, tree)
    out = tree_map(_fetch, tree)
    if rec.enabled:
        rec.event("sync", bytes=int(sum(x.numel() * x.element_size()
                                        for x in leaves)),
                  leaves=len(leaves), dur=round(rec.now() - t0, 6))
    return out


def eval_row(host, s: int) -> dict:
    """Eval point ``s`` of a synced metric buffer (each key's leading axis
    indexes eval points), in the form the per-round loop records: Python
    numbers for scalars, numpy arrays otherwise."""
    out = {}
    for k, v in host.items():
        x = v[s]
        out[k] = x.item() if isinstance(x, np.generic) else x
    return out


def drain_round_telemetry(server: SecureServer, tel_host, *,
                          uplink_bytes=None, cell=None) -> None:
    """The host side of the per-round telemetry block, after the run's
    one host sync: ``tel_host`` maps each key to its (R,) host array.
    Each round becomes a ``round`` event on the flight recorder and a
    ``round_tags`` entry (plus, in async rounds, ``cohort_resample`` and
    ``stale_*`` entries) on the SecureServer's audit chain.  Reads no
    device value."""
    if not tel_host:
        return
    n = len(next(iter(tel_host.values())))
    rec = telemetry.get_recorder()
    extra = {} if cell is None else {"cell": cell}
    for r in range(n):
        row = {k: (v[r].item() if hasattr(v[r], "item") else v[r])
               for k, v in tel_host.items()}
        if uplink_bytes is not None:
            row["uplink_bytes"] = uplink_bytes
        row.update(extra)
        if rec.enabled:
            rec.event("round", index=r + 1, **row)
        tags = {k: row[k] for k in ("kept", "tagged", "c1_pass", "c2_pass")
                if k in row}
        if tags:
            server.record_round_tags(r + 1, **tags, **extra)
        if "cohort" in row:
            server.record_cohort_resample(r + 1, int(row["cohort"]), **extra)
        for decision in ("buffered", "folded", "expired"):
            k = f"stale_{decision}"
            if k in row and int(row[k]) > 0:
                server.record_stale(r + 1, decision, int(row[k]), **extra)


def _record_eval(history, i, metrics, log_every) -> None:
    """Append one eval point's host metric dict to the history (every key
    ``make_eval_fn`` computes is recorded)."""
    history["round"].append(i)
    for k, v in metrics.items():
        history.setdefault(k, []).append(v)
    if log_every and i % log_every == 0:
        print(f"  round {i:5d} acc={metrics['acc']:.4f}")


def _lr_vector(lr_schedule: Callable, rounds: int,
               device: DeviceLike = None) -> torch.Tensor:
    """The schedule at rounds 1..R as one (R,) fp32 device vector (the
    schedules return fp32 values, so the vector holds them exactly).  The
    copy to the card does not block."""
    dev = resolve_device(device)
    v = torch.tensor(np.asarray([lr_schedule(i)
                                 for i in range(1, rounds + 1)],
                                np.float32))
    if dev.type == "cuda":
        v = v.pin_memory()
    return v.to(dev, non_blocking=True)


def _empty_history():
    return {"round": [], "acc": [], "mask_tpr": [], "mask_fpr": [],
            "c1c2": []}


def run_federated_training(model: SmallModel, fed: Federation, cfg: FLConfig,
                           lr_schedule: Callable, log_every: int = 0,
                           generator: Optional[torch.Generator] = None,
                           use_engine: bool = True, host_eval: bool = False,
                           engine=None) -> Dict:
    """Run ``cfg.rounds`` rounds on the federation's device; returns the
    metric history (keys ``round``, ``acc``, ``mask_tpr``, ``mask_fpr``,
    ``c1c2``, ``final_acc``, ``params``, ``streaming_fallback`` and the
    per-round wire traffic of :func:`~repro_torch.fl.metrics.comm_stats`).
    The round draws come from ``generator`` (default: seeded from
    ``cfg.seed`` on the device); the initial params from a generator
    seeded with ``cfg.seed + 1``.  Under a lossy codec the error-feedback
    residuals start at zero.

    The engine (the default) runs the whole run without a host read and
    syncs once at the end (:class:`~repro_torch.fl.engine.RoundEngine`);
    ``host_eval=True`` runs it one eval segment at a time with a sync per
    eval point; ``use_engine=False`` keeps the per-round loop, one sync per
    eval point.  All three give the same history and params, bit for bit.
    ``engine`` reuses a built ``RoundEngine`` (its CUDA graph too); the
    run's scenario comes from this call's ``cfg``, so an engine built for
    one attack magnitude serves another.  ``log_every`` prints eval lines
    as they reach the host: at the end on the one-sync path."""
    from .engine import RoundEngine    # the engine builds on this module
    dev = fed.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = model.init(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                        dev)
    d = sum(v.numel() for v in params.values())
    history = _empty_history()
    if use_engine and engine is None:
        engine = RoundEngine(model, fed, cfg)
    # the wire stats price the per-shard encoding of a model-sharded run
    cstats = comm_stats(cfg, d, model_shards=engine.model_shards
                        if use_engine else 1)
    mode = ("one-sync" if use_engine and not host_eval
            else "host-eval" if use_engine else "per-round")
    run_span = telemetry.span(
        "run_training", n_clients=cfg.n_clients, rounds=cfg.rounds,
        aggregator=cfg.aggregator, attack=cfg.attack.kind, d=int(d),
        chunk=cfg.client_chunk, pods=cfg.pods, codec=cfg.compression,
        streaming=bool(cfg.streaming), mode=mode)
    with torch.no_grad(), run_span:
        if use_engine:
            lrs = _lr_vector(lr_schedule, cfg.rounds, dev)
            scen = make_scenario(cfg, fed)
            if not host_eval:
                with telemetry.span("dispatch"):
                    params, _, metrics, eval_rounds = engine.run_training(
                        params, generator, lrs, scen)
                host = host_sync(metrics)              # THE host sync
                # the telemetry block rides the same sync and never
                # enters the history
                drain_round_telemetry(
                    fed.server, host.pop("_tel", None),
                    uplink_bytes=cstats["uplink_bytes_per_round"])
                for s, i in enumerate(eval_rounds):
                    _record_eval(history, i, eval_row(host, s), log_every)
            else:
                carry = engine.init_carry(params)
                i = 0
                while i < cfg.rounds:
                    n = min(engine.eval_every, cfg.rounds - i)
                    carry, logs = engine.run_segment(carry, generator,
                                                     lrs[i:i + n], scen)
                    i += n
                    with telemetry.phase("eval", dev):
                        m = engine.eval_metrics(engine.carry_params(carry),
                                                logs)
                    with telemetry.phase("handoff", dev):
                        _record_eval(history, i, host_sync(m), log_every)
                params = engine.whole_params(engine.carry_params(carry))
            streaming_fallback = engine.streaming_fallback
        else:
            body = make_round_body(model, fed, cfg)
            eval_fn = make_eval_fn(model, fed, cfg)
            if body.lossy:
                carry = (params, torch.zeros((cfg.n_clients, d),
                                             dtype=torch.float32, device=dev))
            elif body.async_mode:
                carry = (params, init_async_state(cfg, (d,), dev))
            else:
                carry = params
            scen = make_scenario(cfg, fed)
            for i in range(1, cfg.rounds + 1):
                carry, logs = body(carry, lr_schedule(i), generator,
                                   scen=scen)
                params = carry[0] if body.lossy or body.async_mode \
                    else carry
                if i % cfg.eval_every == 0 or i == cfg.rounds:
                    with telemetry.phase("eval", dev):
                        m = eval_fn(params, logs)
                    with telemetry.phase("handoff", dev):
                        _record_eval(history, i, host_sync(m), log_every)
            streaming_fallback = body.streaming_fallback
    history["final_acc"] = history["acc"][-1] if history["acc"] \
        else float("nan")
    history["params"] = params
    history["streaming_fallback"] = streaming_fallback
    history.update(cstats)
    return history


def run_federated_sweep(model: SmallModel, fed: Federation, spec,
                        lr_schedule: Optional[Callable] = None,
                        log_every: int = 0, graph: bool = False) -> list:
    """Run a whole experiment grid (a :class:`~repro_torch.fl.sweep.SweepSpec`):
    the sweep counterpart of :func:`run_federated_training`.  Cells are
    partitioned into structural groups; each group runs on one engine,
    built (and with ``graph=True`` captured) once, with one host sync per
    group.  Returns one history per cell, in ``spec.cells()`` order, each
    bitwise equal to that cell's solo run against a federation created
    with the cell's config and the same federation generator as ``fed``
    (``fl/sweep.py``)."""
    from .sweep import execute_sweep    # sweep builds on this module
    return execute_sweep(model, fed, spec, lr_schedule=lr_schedule,
                         log_every=log_every, graph=graph)
