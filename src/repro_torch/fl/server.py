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
from ..core.aggregators import flatten_updates
from ..core.diversefl import DiverseFLConfig, criterion_logs, guiding_update
from ..core.tee import Enclave
from ..device import DeviceLike
from ..kernels import ops as kops
from .chunking import chunked_vmap
from .compression import quantize_tree
from .telemetry import AuditLog

DEFAULT_IDENTITY = "diversefl-enclave-v1"


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
                                                       ctx.dfl)
    return delta, {"mask": mask, "z_sq": zz, "g_sq": gg,
                   **criterion_logs(dot, zz, gg)}


@register_aggregator("oracle")
def _oracle(U, ctx):
    mask = ~ctx.byz_mask
    return kops.masked_aggregate(U, mask), {"mask": mask}


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
    """[26] in weighted-mean form: a_i = TS_i·‖root‖/‖z_i‖ folds the
    rescale into each client's weight, one pass over U accumulates
    Σ a_i·z_i (the CUDA weighted-fold kernel on the card), one division by
    Σ TS_i finalises."""
    Uf = U.to(torch.float32)
    ts, a = agg.fltrust_weights(Uf, ctx.root_update)
    zeros = torch.zeros((U.shape[1],), dtype=torch.float32, device=U.device)
    s = kops.masked_agg_update(Uf, a, zeros)
    return s / ts.sum().clamp_min(1e-12), {}


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

    # --- Step 3: guiding updates --------------------------------------
    def compute_guides(self, params, grad_fn, lr, E: int = 1,
                       select: Optional[torch.Tensor] = None,
                       client_chunk: Optional[int] = None,
                       codec=None) -> torch.Tensor:
        """Δ̃_j from unsealed samples only — the sole guide-data path.

        ``params`` are the global (unbatched) params; ``grad_fn`` must
        accept client-batched params.  ``select`` restricts to the round's
        participating clients (an index tensor).  ``client_chunk`` bounds
        how many guides are computed at once (``fl/chunking.chunked_vmap``),
        so Step 3 holds O(chunk) guides, not O(C).  ``codec`` (an
        ``fl/compression.Codec``) quantize-dequantizes each guide per
        tensor before the flattening, so that a compressed run compares
        quantized updates against equally quantized guides; a lossless
        codec (or None) changes nothing.  Returns the flat (C, D) fp32
        guide matrix, columns in the layout of
        ``core.aggregators.flatten_updates``."""
        gx, gy = self.guide_batches()
        if select is not None:
            gx, gy = gx[select], gy[select]

        def flat_guides(x, y):
            c = x.shape[0]
            batched = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                       for k, v in params.items()}
            guides = guiding_update(batched, (x, y), grad_fn, lr, E)
            if codec is not None:
                # per tensor, before the ravel: the int8 blocks follow
                # tensor boundaries, as the reference's do
                guides = quantize_tree(codec, guides)
            return flatten_updates(guides)[0]
        return chunked_vmap(flat_guides, (gx, gy), client_chunk)

    def compute_root_update(self, params, grad_fn, lr, E: int, root_x,
                            root_y) -> torch.Tensor:
        """FLTrust's server-side root direction: the same Step-3 SGD on the
        server's root dataset, run as one pseudo-client.  Returns the flat
        (D,) fp32 update, columns in the layout of ``flatten_updates``."""
        batched = {k: v.unsqueeze(0) for k, v in params.items()}
        root = guiding_update(batched, (root_x.unsqueeze(0),
                                        root_y.unsqueeze(0)), grad_fn, lr, E)
        return flatten_updates(root)[0][0]

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
