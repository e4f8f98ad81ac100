"""SecureServer — Algorithm 1's trust boundary, plus the aggregator
registry, in PyTorch.

  * ``SecureServer`` owns the TEE ``Enclave``.  At setup it performs the
    attestation handshake (Step 0) and ingests each client's once-shared
    sample as a *sealed* blob (Step 1).  Guide data is obtained only by
    unsealing those blobs, and the unsealed guide batches are cached on
    the server's device, keyed on the enclave's seal version, so a round
    pays the unseal cost once, not every round.  FLTrust's root update
    (``compute_root_update``) is the same Step-3 SGD on the server's root
    set.
  * The registry maps each aggregation rule name to a strategy with the
    uniform signature ``fn(U, ctx) -> (delta, logs)``, where ``U`` is the
    stacked (N, D) update matrix and ``ctx`` an :class:`AggregationContext`.
    It holds the reference's nine rules: ``diversefl``, ``oracle``,
    ``mean``, ``median``, ``trimmed_mean``, ``krum``, ``bulyan``,
    ``resampling`` and ``fltrust``.

On the card ``diversefl`` launches the CUDA statistics and masked-mean
kernels each round, ``oracle`` and ``mean`` the masked-mean kernel, and
``fltrust`` the weighted-fold kernel (``kernels.ops``).  The median,
trimmed-mean, Krum, Bulyan and resampling rules are plain PyTorch, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core import aggregators as agg
from ..core.diversefl import (DiverseFLConfig, criterion_logs,
                              write_update_rows)
from ..core.tee import Enclave
from ..device import DeviceLike
from ..kernels import ops as kops
from .chunking import chunked_rows
from .compression import quantize_tree
from .telemetry import AuditLog

DEFAULT_IDENTITY = "diversefl-enclave-v1"

# The masked/weighted-mean family: rules whose delta is a per-client-
# weighted mean, folded by the masked-agg kernels (0/1 masks for
# diversefl/oracle/mean, trust-score weights for fltrust).
# ``FLConfig(use_kernel_agg=True)`` with any other rule is refused, as in
# the reference.
KERNEL_AGG_RULES = ("diversefl", "oracle", "mean", "fltrust")


# ----------------------------------------------------------------------
# Aggregator registry
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AggregationContext:
    """Everything a registered rule may need beyond the update matrix."""
    f: int = 0                                  # Byzantine budget
    dfl: DiverseFLConfig = DiverseFLConfig()
    byz_mask: Optional[torch.Tensor] = None     # ground truth (oracle only)
    guides: Optional[torch.Tensor] = None       # G (N, D), enclave Step 3
    stats: Optional[torch.Tensor] = None        # (N, 3) [z·g, ‖z‖², ‖g‖²]
    #                                             in place of the guides
    #                                             (a split round's ranks
    #                                             compute them from their
    #                                             own rows)
    root_update: Optional[torch.Tensor] = None  # (D,) FLTrust root direction
    resample_s: int = 2                         # resampling s_R
    generator: Optional[torch.Generator] = None  # resampling's draw ...
    resample_ids: Optional[torch.Tensor] = None  # ... or its (N, s_R) ids
    codec: Any = None                           # encoded update stream
    #                                             (streaming rules decode)
    stream_shards: Optional[int] = None         # streaming fold groups
    stream_pods: Optional[int] = None           # two-tier pod groups


@dataclasses.dataclass(frozen=True)
class AggregatorEntry:
    name: str
    fn: Callable[[torch.Tensor, AggregationContext],
                 Tuple[torch.Tensor, Dict]]
    needs_guides: bool = False                  # requires ctx.guides
    needs_root: bool = False                    # requires ctx.root_update


_REGISTRY: Dict[str, AggregatorEntry] = {}


def register_aggregator(name: str, *, needs_guides: bool = False,
                        needs_root: bool = False):
    """Decorator: register ``fn(U, ctx) -> (delta, logs)`` under ``name``."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"aggregator {name!r} already registered")
        _REGISTRY[name] = AggregatorEntry(name, fn, needs_guides, needs_root)
        return fn
    return deco


def get_aggregator(name: str) -> AggregatorEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown aggregator {name!r}; "
                         f"available: {available_aggregators()}") from None


def available_aggregators() -> Tuple[str, ...]:
    """Registered rule names, in registration order."""
    return tuple(_REGISTRY)


def aggregate(name: str, U: torch.Tensor, ctx: AggregationContext):
    """Dispatch one aggregation: (N, D) updates -> ((D,) delta, logs)."""
    return get_aggregator(name).fn(U, ctx)


@register_aggregator("diversefl", needs_guides=True)
def _diversefl(U, ctx):
    """Per-client C1/C2 criteria + masked mean (Eq. 2-6)."""
    delta, mask, (dot, zz, gg) = kops.diversefl_step45(U, ctx.guides,
                                                       ctx.dfl, ctx.stats)
    return delta, {"mask": mask, "z_sq": zz, "g_sq": gg,
                   **criterion_logs(dot, zz, gg)}


@register_aggregator("oracle")
def _oracle(U, ctx):
    mask = ~ctx.byz_mask
    return agg.oracle_sgd(U, mask), {"mask": mask}


@register_aggregator("mean")
def _mean(U, ctx):
    ones = torch.ones((U.shape[0],), dtype=torch.float32, device=U.device)
    return kops.masked_aggregate(U, ones), {}


@register_aggregator("median")
def _median(U, ctx):
    return agg.median(U), {}


@register_aggregator("trimmed_mean")
def _trimmed_mean(U, ctx):
    return agg.trimmed_mean(U, ctx.f), {}


@register_aggregator("krum")
def _krum(U, ctx):
    return agg.krum(U, ctx.f), {}


@register_aggregator("bulyan")
def _bulyan(U, ctx):
    return agg.bulyan(U, ctx.f), {}


@register_aggregator("resampling")
def _resampling(U, ctx):
    return agg.resampling(U, ctx.resample_s, generator=ctx.generator,
                          ids=ctx.resample_ids), {}


@register_aggregator("fltrust", needs_root=True)
def _fltrust(U, ctx):
    """[26]: ``core/aggregators.fltrust``, the weighted-fold kernel on the
    card."""
    return agg.fltrust(U, ctx.root_update), {}


# ----------------------------------------------------------------------
# SecureServer
# ----------------------------------------------------------------------

class SecureServer:
    """The FL server's enclave-backed aggregation choke point.

    Setup (Steps 0-1): construct -> attestation handshake; then
    ``ingest_samples`` seals each client's once-shared sample into the
    enclave.  Training (Steps 3-5): ``guide_batches`` exposes the
    *unsealed* samples (cached on the device, invalidated whenever the
    sealed store changes), ``compute_guides`` runs the enclave-side
    guiding updates, and ``aggregate`` dispatches through the registry.
    """

    def __init__(self, enclave: Optional[Enclave] = None,
                 identity: str = DEFAULT_IDENTITY, nonce: int = 0x5ecf1,
                 device: DeviceLike = None):
        self.enclave = enclave if enclave is not None \
            else Enclave(identity, device=device)
        self.device = self.enclave.device
        # append-only, hash-chained record of every enclave-side decision:
        # attestation, seals/drops, guide-cache rebuilds.  Only ids,
        # counts, versions and measurements are logged.
        self.audit = AuditLog()
        quote = self.enclave.attest(nonce)
        if not Enclave.verify_quote(quote, identity, nonce):
            raise RuntimeError(
                f"attestation failed: enclave does not measure as {identity!r}")
        self.audit.append("attestation", identity=identity, nonce=nonce,
                          measurement=quote.measurement)
        self._guide_cache = None             # (seal_version, gx, gy)

    # --- Step 1: sealed-sample ingestion ------------------------------
    def ingest_samples(self, client_id: int, x, y) -> None:
        """Seal one client's shared sample M_j⁰ into the enclave."""
        self.enclave.seal_samples(client_id, x, y)
        self.audit.append("seal", client=int(client_id),
                          version=self.enclave.seal_version)

    def drop_client(self, client_id: int) -> None:
        self.enclave.drop_client(client_id)
        self.audit.append("drop", client=int(client_id),
                          version=self.enclave.seal_version)

    # --- unsealed guide batches (cached on the device) ----------------
    def guide_batches(self, refresh: bool = False):
        """Guide batches stacked BY CLIENT ID: row j is client j's sample,
        obtained only by unsealing.  A dropped (or never-ingested) id gets
        an all-zero row: a zero guiding update fails both C1 (dot = 0) and
        C2 (‖Δ̃‖ = 0), so such a client never passes the criterion.  The
        unseal runs once per seal version."""
        version = self.enclave.seal_version
        if refresh or self._guide_cache is None \
                or self._guide_cache[0] != version:
            ids = self.enclave.client_ids()
            if not ids:
                raise RuntimeError(
                    "SecureServer has no sealed samples — ingest_samples "
                    "must run before guide_batches")
            unsealed = {j: self.enclave.unseal_samples(j) for j in ids}
            zx, zy = (torch.zeros_like(t) for t in unsealed[ids[0]])
            rows = [unsealed.get(j, (zx, zy)) for j in range(max(ids) + 1)]
            self._guide_cache = (version,
                                 torch.stack([r[0] for r in rows]),
                                 torch.stack([r[1] for r in rows]))
            self.audit.append("guide_cache_rebuild", version=version,
                              clients=len(ids))
        return self._guide_cache[1], self._guide_cache[2]

    # --- audit: per-round decisions, committed after the run's sync ---
    def record_round_tags(self, round_index: int, **counts) -> None:
        """Commit one round's tag decision counts (kept/tagged clients,
        C1/C2 pass counts) to the audit chain.  The counts come from the
        on-device telemetry block after the run's one host sync."""
        self.audit.append(
            "round_tags", round=int(round_index),
            **{k: (v.item() if hasattr(v, "item") else v)
               for k, v in counts.items()})

    def record_cohort_resample(self, round_index: int, cohort: int,
                               **extra) -> None:
        """Commit one round's live cohort size (participants after
        dropout faults) to the audit chain."""
        self.audit.append("cohort_resample", round=int(round_index),
                          cohort=int(cohort), **extra)

    def record_stale(self, round_index: int, decision: str,
                     count: int, **extra) -> None:
        """Commit one round's staleness decision count: ``buffered`` (a
        straggler's update entered the pending slab), ``folded`` (a
        buffered update landed and went through Eq. 6) or ``expired``
        (dropped: no free slot, no buffer, or over the staleness cap)."""
        if decision not in ("buffered", "folded", "expired"):
            raise ValueError(
                f"unknown staleness decision {decision!r}; expected "
                f"'buffered', 'folded' or 'expired'")
        self.audit.append(f"stale_{decision}", round=int(round_index),
                          count=int(count), **extra)

    # --- Step 3: guiding updates --------------------------------------
    def compute_guides(self, params, grad_fn, lr, E: int = 1,
                       select: Optional[torch.Tensor] = None,
                       client_chunk: Optional[int] = None,
                       codec=None, like=None,
                       l2: float = 0.0) -> torch.Tensor:
        """Δ̃_j from unsealed samples only — the sole guide-data path.

        ``params`` are the global (unbatched) params; ``grad_fn`` must
        accept client-batched params.  ``l2`` is a ridge term ``grad_fn``
        leaves out, added in the step (``core.diversefl.
        write_update_rows``, which writes each guide's row once).
        ``select`` restricts to the round's participating
        clients (an index tensor).  ``client_chunk`` bounds how many guides
        are computed at once (``fl/chunking.chunked_rows``), so Step 3
        holds O(chunk) per-client gradients, not O(C).  ``codec`` (an
        ``fl/compression.Codec``) quantize-dequantizes each guide per
        tensor, in place on each leaf's columns of its rows, so that a
        compressed run compares quantized updates against equally
        quantized guides; a lossless codec (or None) changes nothing.
        Returns the flat (C, D) fp32 guide matrix, columns in the layout of
        ``core.aggregators.flatten_updates``.  On a model axis > 1
        ``params`` are the rank's tiles and ``like`` the whole params'
        shapes: the guides are the tiles', (C, D_s), each quantised as its
        whole tensor is (``compression.quantize_tree``)."""
        gx, gy = self.guide_batches()
        if select is not None:
            gx, gy = gx[select], gy[select]
        lossy = codec is not None and not codec.lossless
        cols, off = {}, 0
        for k in sorted(params):
            cols[k] = (off, params[k].numel())
            off += params[k].numel()
        G = torch.empty((gx.shape[0], off), dtype=torch.float32,
                        device=gx.device)

        def guide_rows(x, y, row0, rows):
            c = x.shape[0]
            start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                     for k, v in params.items()}
            write_update_rows(G, start, [(x, y)] * E, grad_fn, lr, l2,
                              clients=c, row0=row0, rows=rows)
            if lossy:
                # per tensor, on each leaf's columns: the int8 blocks follow
                # tensor boundaries, as the reference's do.  In the params'
                # order, the order of quantize_tree's gathers on a model axis
                blk = G[row0:row0 + rows]
                parts = {}
                for k in params:
                    a, n = cols[k]
                    parts[k] = blk[:, a:a + n].reshape(
                        (rows,) + tuple(params[k].shape))
                for k, q in quantize_tree(codec, parts, like=like).items():
                    a, n = cols[k]
                    blk[:, a:a + n] = q.reshape(rows, n)
        chunked_rows(guide_rows, (gx, gy), client_chunk)
        return G

    def compute_root_update(self, params, grad_fn, lr, E: int, root_x,
                            root_y, l2: float = 0.0) -> torch.Tensor:
        """FLTrust's server-side root direction: the same Step-3 SGD on the
        server's root dataset, run as one pseudo-client through the guides'
        row writer.  Returns the flat (D,) fp32 update, columns in the
        layout of ``flatten_updates``."""
        batched = {k: v.unsqueeze(0) for k, v in params.items()}
        out = torch.empty((1, sum(v.numel() for v in params.values())),
                          dtype=torch.float32, device=root_x.device)
        write_update_rows(out, batched, [(root_x.unsqueeze(0),
                                          root_y.unsqueeze(0))] * E,
                          grad_fn, lr, l2, clients=1)
        return out[0]

    # --- Steps 4-5: criterion + aggregation ---------------------------
    @staticmethod
    def aggregate(name: str, U, ctx: AggregationContext):
        return aggregate(name, U, ctx)

    @staticmethod
    def streaming_aggregator(name: str, ctx: AggregationContext):
        """The bound streaming AggState monoid for ``name``, the O(D)
        counterpart of :meth:`aggregate` (``fl/streaming.py``), or None
        when the rule exists only densely and the caller must fall back
        to the (C, D) path."""
        from .streaming import get_streaming    # streaming imports this
        entry = get_streaming(name)             # module's registry
        return None if entry is None else entry.bind(ctx)
