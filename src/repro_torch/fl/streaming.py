"""Streaming aggregation: constant-memory partial aggregation, in PyTorch.

The dense round holds the (C, D) update matrix and its (C, D) guide twin.
For every *associative* rule this module removes both:

  * **AggState monoid.**  A streaming rule is a
    :class:`StreamingAggregator` with ``init(d) -> state`` (the identity),
    ``update(state, u_i, ctx_i) -> (state, logs_i)`` (one client's update
    folded in), ``merge(a, b) -> state`` (partial states of disjoint
    client sets) and ``finalize(state) -> (delta, logs)``.  ``state`` is
    O(D).  ``update(s, u, c)`` equals ``merge(s, update(init, u, c))`` up
    to fp rounding.
  * **Registry beside the dense one.**  Streaming rules register under
    the names of ``fl/server.py``'s dense rules (a name the dense
    registry lacks is refused): ``mean``, ``oracle``, ``diversefl`` and
    ``fltrust``, all weighted means with per-client weights.  The other
    rules are not associative (``NON_STREAMING`` says why) and fall back
    to the dense path with the reason logged.
  * **The sweep.**  :func:`stream_aggregate` computes one ``chunk``-sized
    block of client updates at a time (the blocks of
    ``fl/chunking.pad_to_blocks``) and folds it into the state with the
    rule's ``update_block``, through the kernel ops: the weighted-fold
    kernel for an fp32 or bf16 block, the dequantize-and-fold kernel for
    an int8 one, and DiverseFL's weights from the similarity kernel.  A
    block is freed before the next is computed, so a round holds O(chunk
    · D) of updates instead of O(C · D).

**Bitwise contract.**  The block folds continue one client-ordered
chain from the carried accumulator, the chain the dense masked-mean
kernel (or, on the CPU, ``core.diversefl.masked_sum_fold``) walks, so for
the 0/1-weighted rules (diversefl, oracle, mean) streaming equals dense
bit for bit at any chunk; padding rows get weight 0.  FLTrust's Σ TSᵢ is
summed per block, so it agrees to fp tolerance.  ``shards``/``pods`` > 1
reassociate the merge: per-client logs stay bitwise, the delta agrees to
fp tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core.diversefl import criterion_logs, diversefl_mask
from ..kernels import ops as kops
from .chunking import (block_valid, group_blocks_2d, pad_to_blocks,
                       resolve_pods, resolve_shards, tree_leaves, tree_map,
                       unblock)
from .server import _REGISTRY as _DENSE_REGISTRY
from .server import AggregationContext

AggState = Tuple[torch.Tensor, torch.Tensor]   # (Σ aᵢuᵢ (D,), Σ bᵢ ())
ClientCtx = Dict[str, torch.Tensor]            # per-client guide/byz/valid


@dataclasses.dataclass(frozen=True)
class StreamingAggregator:
    """A bound streaming rule: an AggState monoid over client updates.
    ``weights(U_blk, ctx_blk)`` maps a (c, D) block to per-client
    (numerator weight, denominator weight, logs); ``update_block`` folds
    a whole block in one step through the kernel ops."""
    init: Callable[..., AggState]
    update: Callable[[AggState, Any, ClientCtx], Tuple[AggState, Dict]]
    merge: Callable[[AggState, AggState], AggState]
    finalize: Callable[[AggState], Tuple[torch.Tensor, Dict]]
    weights: Callable
    update_block: Callable


@dataclasses.dataclass(frozen=True)
class StreamingEntry:
    """Registry row: ``bind(ctx)`` closes a rule over the round's context
    (DiverseFL thresholds, root update, codec) and returns the monoid."""
    name: str
    bind: Callable[[AggregationContext], StreamingAggregator]


_STREAMING: Dict[str, StreamingEntry] = {}

# Why each dense-only rule cannot fold into an O(D) state: the logged
# fallback reason when FLConfig.streaming=True asks for one of these.
NON_STREAMING: Dict[str, str] = {
    "median": "coordinate-wise median needs every client's value per "
              "dimension — order statistics do not form a bounded monoid",
    "trimmed_mean": "per-dimension trimming needs the full sorted column "
                    "of client values",
    "krum": "Krum scores couple every pair of clients (pairwise "
            "distances), so no per-client fold exists",
    "bulyan": "recursive Krum selection couples every pair of clients",
    "resampling": "resampled groups average arbitrary client subsets "
                  "before the median — group membership is not a fold",
}


def register_streaming(name: str):
    """Decorator: register ``bind(ctx) -> StreamingAggregator`` under a
    name the dense registry already knows."""
    def deco(bind_fn):
        if name in _STREAMING:
            raise ValueError(f"streaming rule {name!r} already registered")
        if name not in _DENSE_REGISTRY:
            raise ValueError(
                f"streaming rule {name!r} has no dense AggregatorRegistry "
                f"counterpart — register the dense rule first so the two "
                f"registries cannot drift")
        _STREAMING[name] = StreamingEntry(name, bind_fn)
        return bind_fn
    return deco


def get_streaming(name: str) -> Optional[StreamingEntry]:
    """The streaming entry for ``name``, or None if the rule exists only
    densely (callers fall back with :func:`fallback_reason`)."""
    return _STREAMING.get(name)


def streaming_rules() -> Tuple[str, ...]:
    """Registered streaming rule names, in registration order."""
    return tuple(_STREAMING)


def fallback_reason(name: str) -> Optional[str]:
    """Why ``name`` cannot stream (None when it can)."""
    if name in _STREAMING:
        return None
    return NON_STREAMING.get(
        name, "no streaming AggState registered for this rule")


# ----------------------------------------------------------------------
# The weighted-mean family
# ----------------------------------------------------------------------

def stat_sum(x: torch.Tensor) -> torch.Tensor:
    """Per-client sum over the flat model dimension (the last axis)."""
    return x.sum(-1)


def weighted_mean_rule(weight_fn: Callable, *, floor: float = 1.0,
                       codec=None) -> StreamingAggregator:
    """The AggState monoid of a weighted-mean rule.

    ``weight_fn(u, ctx) -> (a, b, logs)``: client i adds ``aᵢ·uᵢ`` to the
    numerator and ``bᵢ`` to the denominator; ``finalize`` divides once,
    ``s / max(n, floor)``.  ``weight_fn`` reduces over the last axis, so
    one body serves a (D,) row in ``update`` and a (c, D) block in
    ``weights``.

    ``codec`` (an ``fl/compression.Codec``, from ``ctx.codec``) marks the
    stream as encoded: ``u`` arrives as the codec's dict and is decoded
    before the weights, so per-client statistics see the decoded values,
    the bits the dense path's rules see.  The block fold reads the
    payload itself: an fp32 or bf16 block through the weighted-fold
    kernel (its widening of bf16 is the decode), an int8 block through
    the dequantize-and-fold kernel.

    On the raw fp32 stream (``codec=None``) a non-finite guard screens
    every row: a client whose update holds a NaN or Inf gets weight 0
    and its values are zeroed before anything multiplies them (NaN · 0 is
    NaN, so zeroing the weight alone would not do).  On finite data the
    guard changes no bit.  Rows whose ``valid`` context is 0 (padding)
    get weight exactly 0.
    """
    decode = (lambda u: u) if codec is None else codec.decode
    guard = codec is None

    def _screen(ud):
        """(sanitised update, finite-row bits or None).
        ``stat_sum(ud * 0.0)`` is 0 iff every element is finite."""
        if not guard:
            return ud, None
        fin = torch.isfinite(stat_sum(ud * 0.0))
        mask = fin.unsqueeze(-1) if fin.dim() else fin
        return torch.where(mask, ud, 0.0), fin

    def _weigh(ud, ctx):
        """Shared by the row and block forms: weights with the guard's
        finite bits and the ``valid`` channel folded in."""
        ud, fin = _screen(ud)
        a, b, logs = weight_fn(ud, ctx)
        if fin is not None:
            ff = fin.to(torch.float32)
            a, b = a * ff, b * ff
            logs = dict(logs, nonfinite=~fin)
        v = ctx.get("valid")
        if v is not None:
            vf = v.to(torch.float32)
            a, b = a * vf, b * vf
        return ud, a, b, logs

    def init(d: int, device=None) -> AggState:
        return (torch.zeros((d,), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))

    def update(state, u, ctx):
        s, n = state
        ud, a, b, logs = _weigh(decode(u), ctx)
        return (s + ud.to(torch.float32) * a, n + b), logs

    def merge(x, y):
        return (x[0] + y[0], x[1] + y[1])

    def finalize(state):
        s, n = state
        return s / n.clamp_min(floor), {}

    def weights(U, ctx_blk):
        _, a, b, logs = _weigh(decode(U), ctx_blk)
        return a, b, logs

    def update_block(state, U, ctx_blk):
        s, n = state
        ud, a, b, logs = _weigh(decode(U), ctx_blk)
        if codec is None:
            s = kops.masked_agg_update(ud, a, s)
        elif codec.qblock is not None:
            # the int8 payload: decode fused into the fold's one pass
            s = kops.dequant_fold_update(U["q"], U["scale"], a, s,
                                         codec.qblock)
        else:
            # the bf16 payload: the kernel widens it, exactly
            s = kops.masked_agg_update(U["q"], a, s)
        return (s, n + b.sum()), logs

    return StreamingAggregator(init, update, merge, finalize,
                               weights=weights, update_block=update_block)


@register_streaming("mean")
def _mean_stream(ctx: AggregationContext) -> StreamingAggregator:
    def weight(u, ci):
        one = torch.ones(u.shape[:-1], dtype=torch.float32, device=u.device)
        return one, one, {}
    return weighted_mean_rule(weight, codec=ctx.codec)


@register_streaming("oracle")
def _oracle_stream(ctx: AggregationContext) -> StreamingAggregator:
    def weight(u, ci):
        keep = ~ci["byz"]
        w = keep.to(torch.float32)
        return w, w, {"mask": keep}
    return weighted_mean_rule(weight, codec=ctx.codec)


@register_streaming("diversefl")
def _diversefl_stream(ctx: AggregationContext) -> StreamingAggregator:
    dfl = ctx.dfl

    def weight(u, ci):
        # C1/C2 per client against its guiding update.  A block's
        # statistics come from the similarity kernel op, whose rows equal
        # the dense rule's; one row reduces in place.
        g = ci["guide"].to(torch.float32)
        uf = u.to(torch.float32)
        if uf.dim() == 2:
            dot, zz, gg = kops.similarity_stats(uf, g).unbind(1)
        else:
            dot, zz, gg = stat_sum(uf * g), stat_sum(uf * uf), stat_sum(g * g)
        keep = diversefl_mask(dot, zz, gg, dfl)
        w = keep.to(torch.float32)
        return w, w, {"mask": keep, "z_sq": zz, "g_sq": gg,
                      **criterion_logs(dot, zz, gg)}
    return weighted_mean_rule(weight, codec=ctx.codec)


@register_streaming("fltrust")
def _fltrust_stream(ctx: AggregationContext) -> StreamingAggregator:
    root = ctx.root_update.to(torch.float32)
    rn = torch.sqrt((root * root).sum()) + 1e-12

    def weight(u, ci):
        uf = u.to(torch.float32)
        un = torch.sqrt(stat_sum(uf * uf)) + 1e-12
        ts = torch.relu(stat_sum(uf * root) / (un * rn))
        return ts * (rn / un), ts, {}
    return weighted_mean_rule(weight, floor=1e-12, codec=ctx.codec)


# ----------------------------------------------------------------------
# The streaming sweep
# ----------------------------------------------------------------------

def tree_merge(merge: Callable, states: List[AggState]) -> AggState:
    """Canonical fixed-association merge of partial states: a balanced
    binary tree over the list index (round 1 merges (s0, s1), (s2, s3),
    ...; an odd tail passes through; repeat).  The association depends on
    the number of states alone; one state is returned unmerged."""
    parts = list(states)
    while len(parts) > 1:
        parts = [merge(parts[i], parts[i + 1]) if i + 1 < len(parts)
                 else parts[i] for i in range(0, len(parts), 2)]
    return parts[0]


class _Stack:
    """Per-block outputs written into one preallocated (k, chunk, ...)
    buffer per leaf as they come, so no second copy of them is made."""

    def __init__(self, k: int):
        self.k, self.buf = k, None

    def put(self, b: int, tree) -> None:
        if self.buf is None:
            self.buf = tree_map(lambda x: x.new_empty((self.k,) + x.shape),
                                tree)
        for dst, src in zip(tree_leaves(self.buf), tree_leaves(tree)):
            dst[b].copy_(src)


def stream_aggregate(rule: StreamingAggregator, block_fn: Callable,
                     args: tuple, chunk: Optional[int], *, d: int,
                     shards: Optional[int] = None,
                     pods: Optional[int] = None,
                     block_extra: bool = False):
    """Fold per-client updates into ``rule``'s state one ``chunk``-sized
    block at a time; the (C, D) update matrix never exists.

    ``args`` is a pytree of tensors sharing the leading client axis C (the
    minibatch stacks and O(C) per-client values); ``block_fn(blk, valid)
    -> (U_blk, ctx_blk)`` computes one block's updates (a (chunk, D)
    tensor or a codec's encoded dict) and per-client context from the
    block's slice of ``args``; ``valid`` (chunk,) marks the real rows.
    Blocks are computed and folded in block order.  Per-client logs come
    back as (C, ...) tensors with the padding rows dropped.

    ``shards`` (S) and ``pods`` (P) set the fold's association: the k
    blocks split into P contiguous pod groups and, within each, S
    contiguous shard groups; each group is folded from ``init`` by the
    same left fold, the S partials of a pod are combined by
    :func:`tree_merge`, then the P pod states.  ``None`` means 1 (the
    port runs on one device); a shard count is clamped to a divisor of
    the block count, an explicit pod count that does not divide it
    raises.  S = P = 1 is the sequential sweep.

    ``block_extra=True``: ``block_fn`` returns a third element, a
    (chunk, ...) pytree that rides out of the fold beside the logs (the
    error-feedback residual rows), unblocked to (C, ...) and returned
    fourth.

    Returns ``(delta, agg_logs, client_logs)`` (plus ``extra``).
    """
    leaves = tree_leaves(args)
    C = leaves[0].shape[0]
    device = leaves[0].device
    chunk = C if chunk is None or chunk >= C else chunk
    blocks, k, _ = pad_to_blocks(args, chunk)
    valid = block_valid(k, chunk, C, device)
    P = resolve_pods(pods, k)
    S = resolve_shards(shards if shards is not None else 1, k // P)
    logs_out, extra_out = _Stack(k), _Stack(k)

    def fold(ids) -> AggState:
        state = rule.init(d, device)
        for b in ids.tolist():
            out = block_fn(tree_map(lambda x, b=b: x[b], blocks), valid[b])
            U_blk, ctx_blk = out[0], dict(out[1], valid=valid[b])
            state, logs = rule.update_block(state, U_blk, ctx_blk)
            logs_out.put(b, logs)
            if block_extra:
                extra_out.put(b, out[2])
        return state

    # group ids: (P, S, k / (P·S)) block indices, pod-major and contiguous
    ids = group_blocks_2d(torch.arange(k), k, P, S)
    pod_states = [tree_merge(rule.merge, [fold(g) for g in pod])
                  for pod in ids]
    state = tree_merge(rule.merge, pod_states)
    delta, agg_logs = rule.finalize(state)
    client_logs = unblock(logs_out.buf, k, chunk, C)
    if block_extra:
        return (delta, agg_logs, client_logs,
                unblock(extra_out.buf, k, chunk, C))
    return delta, agg_logs, client_logs

