"""Chunked client mapping: the client axis in blocks of ``chunk``.

``pad_to_blocks`` pads the shared leading client axis C of a tuple of
tensors (a pytree of tuples, lists and dicts; ``None`` leaves pass
through) to a multiple of ``chunk`` with copies of the first rows and
cuts it into ``(k, chunk, ...)`` blocks.  ``chunked_vmap`` applies a
function to each block and concatenates the results with the padding
rows dropped; the streaming fold (``fl/streaming.py``) sweeps the same
blocks, folding each into an O(D) state instead.  One partition
definition keeps the two sweeps row-aligned, which the bitwise
streaming == dense contract depends on.

``group_blocks``/``group_blocks_2d`` cut the k blocks into contiguous
shard (and pod) groups: the association of the sharded and two-tier
folds.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


class ShardMismatchError(ValueError):
    """A requested shard or pod count cannot tile the block axis it
    partitions.  Raised with the numbers named, so that the caller can
    pick a ``client_chunk`` whose block count tiles, or let the count
    clamp."""


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested tuples, lists and
    dicts; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of ``tree``, in :func:`tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def pad_to_blocks(args, chunk: int) -> Tuple[Any, int, int]:
    """Pad the leading axis C of every tensor in ``args`` to a multiple of
    ``chunk`` with copies of the first rows and reshape each to ``(k,
    chunk, ...)`` blocks.  Returns ``(blocks, k, C)``.  The padding rows
    mean nothing: consumers drop their outputs (:func:`unblock`) or give
    them weight 0 (:func:`block_valid`)."""
    leaves = tree_leaves(args)
    if not leaves:
        raise ValueError("pad_to_blocks needs at least one tensor argument")
    C = leaves[0].shape[0]
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if chunk > C:
        # x[:pad] cannot supply more than C padding rows; callers take the
        # single-block path for chunk >= C
        raise ValueError(
            f"chunk ({chunk}) exceeds the leading axis ({C}); take the "
            f"single-block path for chunk >= C")
    k = -(-C // chunk)
    pad = k * chunk - C

    def to_blocks(x):
        if pad:
            x = torch.cat([x, x[:pad]], dim=0)
        return x.reshape((k, chunk) + tuple(x.shape[1:]))

    return tree_map(to_blocks, args), k, C


def unblock(out, k: int, chunk: int, C: int):
    """Inverse of :func:`pad_to_blocks` on outputs: (k, chunk, ...) ->
    (C, ...), padding rows dropped."""
    return tree_map(
        lambda x: x.reshape((k * chunk,) + tuple(x.shape[2:]))[:C], out)


def block_valid(k: int, chunk: int, C: int, device=None) -> torch.Tensor:
    """(k, chunk) bool: True where a block row is a real client, False on
    the padding rows of the last block."""
    return (torch.arange(k * chunk, device=device) < C).reshape(k, chunk)


def resolve_shards(shards: int, k: int) -> int:
    """Clamp a requested shard count to the largest divisor of the block
    count ``k`` not above it: contiguous groups must tile the blocks."""
    s = max(1, min(int(shards), k))
    while k % s:
        s -= 1
    return s


def group_blocks(blocks, k: int, shards: int):
    """(k, chunk, ...) blocks -> (shards, k // shards, chunk, ...):
    shard j owns the contiguous blocks [j·k/S, (j+1)·k/S)."""
    if k % shards:
        raise ShardMismatchError(
            f"shards ({shards}) must divide the block count ({k}); "
            f"use resolve_shards")
    return tree_map(
        lambda x: x.reshape((shards, k // shards) + tuple(x.shape[1:])),
        blocks)


def resolve_pods(pods: Optional[int], k: int, auto: int = 1) -> int:
    """The pod count the two-tier fold uses.  ``None`` clamps ``auto`` to
    a divisor of the block count ``k``; an explicit count that does not
    divide ``k`` raises :class:`ShardMismatchError`."""
    if pods is None:
        return resolve_shards(auto, k)
    p = int(pods)
    if p < 1:
        raise ShardMismatchError(f"pods must be >= 1, got {p}")
    if p > k or k % p:
        raise ShardMismatchError(
            f"pods ({p}) must divide the padded block count ({k}); pick a "
            f"client_chunk so ceil(C / chunk) tiles the pods, or pass "
            f"pods=None to clamp")
    return p


def group_blocks_2d(blocks, k: int, pods: int, shards: int):
    """(k, chunk, ...) blocks -> (pods, shards, k / (pods·shards), chunk,
    ...): pod p owns the contiguous blocks [p·k/P, (p+1)·k/P), and within
    it shard s a contiguous sub-range, so flattening the first two axes
    gives :func:`group_blocks` with pods·shards groups."""
    if k % pods:
        raise ShardMismatchError(
            f"pods ({pods}) must divide the block count ({k}); "
            f"use resolve_pods")
    if (k // pods) % shards:
        raise ShardMismatchError(
            f"per-pod shards ({shards}) must divide the per-pod block "
            f"count ({k // pods}); use resolve_shards")
    return tree_map(
        lambda x: x.reshape((pods, shards, k // (pods * shards))
                            + tuple(x.shape[1:])), blocks)


def chunked_vmap(fn: Callable, args: tuple, chunk: Optional[int] = None):
    """``fn(*args)`` over the shared leading client axis of ``args``, at
    most ``chunk`` clients at a time.  ``fn`` takes client-batched
    arguments (the port's batched form of ``vmap``); with ``chunk=None``
    or ``chunk >= C`` it runs once on all of them.  Otherwise it runs on
    each (chunk, ...) block of :func:`pad_to_blocks` and the outputs are
    concatenated with the padding rows dropped."""
    leaves = tree_leaves(args)
    if not leaves:
        raise ValueError("chunked_vmap needs at least one tensor argument")
    C = leaves[0].shape[0]
    if chunk is None or chunk >= C:
        return fn(*args)
    blocks, k, C = pad_to_blocks(args, chunk)
    outs = [fn(*tree_map(lambda x, b=b: x[b], blocks)) for b in range(k)]
    first = outs[0]
    if isinstance(first, dict):
        return {key: torch.cat([o[key] for o in outs])[:C] for key in first}
    return torch.cat(outs)[:C]
