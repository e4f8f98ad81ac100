"""Sharding on ``torch.distributed``: the client x model mesh.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with axes
``("data", "model")`` (one pod) or ``("pod", "data", "model")``.  FL
clients live on the (pod, data) axes, pod-major: client range ``[c·C/R,
(c+1)·C/R)`` of ``C`` belongs to the rank whose flat (pod, data) index is
``c`` of ``R``, the layout the reference's ``("pod", "data")`` placement
gives.  Each rank holds its own block of every client-stacked quantity;
off-mesh every helper is the identity.

On a model axis ``ms`` > 1 the parameters are tensor-parallel, as the
reference's ``place_params`` leaves them: every leaf whose partition-table
dim (:data:`_RULES`) tiles ``ms`` lives as this rank's tile, a fresh
tensor (:func:`place_params`); a leaf whose dim does not tile stays whole
on every rank.  The zoo's forward and backward run split across the
model group (megatron-style column/row splits, vocab-parallel embedding
and loss, expert-parallel MoE, channel-parallel Mamba; ``models/``),
through the counted autograd operators :func:`copy_to_model`,
:func:`reduce_from_model` and :func:`gather_tile`.  So a rank's gradient
of a tiled leaf is its tile's gradient, and a replicated leaf's gradient
is whole and the same on every rank of the group.

The federated state is the blocked ``(ms, L)`` layout of
:func:`flatten_updates_sharded`, of which model rank ``s`` keeps row
``s``.  Row ``s`` of a tiled leaf is exactly its tile raveled, so a rank
builds its row from its tiles with no collective
(:meth:`BlockedLayout.local_rows`) and turns its row of the round delta
back into tiles the same way (:meth:`BlockedLayout.unravel_local`); only
the replicated leaves' column bands cross the model group, in one
``all_gather``.  :func:`gather_params` rebuilds the whole params.
:func:`shard` records its hint.

Every collective the port issues goes through :func:`all_reduce` or
:func:`all_gather` here, which count it in :data:`COLLECTIVES`: a run on a
trivial mesh (1 x 1), and a model with no tiled leaf on any mesh without
data ranks, issues none.  A failed collective raises; nothing catches it.

Specs are tuples with the reference's ``PartitionSpec`` entries: an axis
name, a tuple of names, or ``None`` per dim (``()`` replicates).
"""
from __future__ import annotations

import collections
import contextlib
import math
import re
import threading
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from ..convert import leaf_paths, unflatten_like

MODEL_AXIS = "model"
POD_AXIS = "pod"
DATA_AXES = ("pod", "data")  # whichever exist in the active mesh

_state = threading.local()


class ShardMismatchError(ValueError):
    """A requested shard or pod count cannot tile the axis it partitions.

    Raised with the offending numbers named (count, block count, the
    chunking that produced it), so that the caller can pick a
    ``client_chunk`` whose block count tiles, or drop the forced count and
    let the mesh-derived value clamp."""


def get_mesh():
    return getattr(_state, "mesh", None)


def set_mesh(mesh) -> None:
    _state.mesh = mesh


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


# ----------------------------------------------------------------------
# Counted collectives
# ----------------------------------------------------------------------

COLLECTIVES = {"all_reduce": 0, "all_gather": 0}
_RECORDS = []     # the lists of the active record_collectives() blocks


def collective_counts() -> dict:
    """A snapshot of :data:`COLLECTIVES`."""
    return dict(COLLECTIVES)


@contextlib.contextmanager
def record_collectives():
    """Yields a list to which every :func:`all_reduce`/:func:`all_gather`
    inside the block appends ``{"kind", "dtype", "shape", "group_size"}``
    (the HLO kind, the wire dtype, the input's shape), the input of
    ``launch.hlo.collective_stats``.  Blocks nest; each sees its own
    calls."""
    out = []
    _RECORDS.append(out)
    try:
        yield out
    finally:
        # by identity: two blocks' lists may be equal
        del _RECORDS[next(i for i, r in enumerate(_RECORDS) if r is out)]


def _record(kind: str, x: torch.Tensor, group) -> None:
    if _RECORDS:
        rec = {"kind": kind, "dtype": x.dtype, "shape": tuple(x.shape),
               "group_size": dist.get_world_size(group)}
        for out in _RECORDS:
            out.append(dict(rec))


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """SUM-reduce ``x`` in place over ``group``; returns ``x``."""
    COLLECTIVES["all_reduce"] += 1
    _record("all-reduce", x, group)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, stacked in group rank order:
    ``(group size, *x.shape)``.  Booleans travel as uint8."""
    COLLECTIVES["all_gather"] += 1
    src = x.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    _record("all-gather", src, group)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    out = torch.stack(out)
    return out.bool() if x.dtype == torch.bool else out


# ----------------------------------------------------------------------
# Tensor-parallel autograd operators over the model group
# ----------------------------------------------------------------------

def tp_group():
    """The model group of the active mesh when its model axis is > 1,
    else None (no tensor parallelism)."""
    mesh = get_mesh()
    if mesh is None or model_shard_count(mesh) <= 1:
        return None
    return model_group(mesh)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """SUM of ``x`` over ``group``, reduced in fp32 and rounded once to
    ``x``'s dtype; ``x`` is left as it was."""
    y = x.to(torch.float32, copy=True).contiguous()
    all_reduce(y, group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTile(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tile, dim, group, same_grad):
        ctx.dim, ctx.group, ctx.same_grad = dim, group, same_grad
        ctx.n, ctx.s = tile.shape[dim], dist.get_rank(group)
        return torch.cat(all_gather(tile, group).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.same_grad:
            g = _summed(g, ctx.group)
        return (g.narrow(ctx.dim, ctx.s * ctx.n, ctx.n).contiguous(), None,
                None, None)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Enter a model-parallel region: the identity forward, an
    ``all_reduce`` of the gradient backward (each rank's use of ``x`` is
    partial).  The identity without a model axis > 1."""
    group = tp_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Leave a model-parallel region: the ranks' partial ``x`` summed by
    one ``all_reduce`` (in fp32, rounded once to ``x``'s dtype) forward,
    the identity backward.  The identity without a model axis > 1."""
    group = tp_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_tile(tile: torch.Tensor, dim: int = -1,
                same_grad: bool = False) -> torch.Tensor:
    """The whole tensor from every model rank's ``tile`` along ``dim``, in
    rank order (one ``all_gather`` forward).  Backward keeps this rank's
    slice of the gradient, after summing the group's gradients (each
    rank's use of the whole is partial) unless ``same_grad`` says every
    rank's gradient is the same (a replicated use).  It saves nothing:
    the backward needs no forward value."""
    group = tp_group()
    if group is None:
        return tile
    return _GatherTile.apply(tile, dim % tile.dim(), group, same_grad)


def tp_rank_count():
    """``(s, ms)``: this rank's model coordinate and the model axis size
    of the active mesh; ``(0, 1)`` without tensor parallelism."""
    mesh = get_mesh()
    ms = model_shard_count(mesh)
    return (model_index(mesh), ms) if ms > 1 else (0, 1)


def col_blocks(w: torch.Tensor, whole: int, ranges, dim: int = -1):
    """``[w[..., lo:hi, ...] for (lo, hi) in ranges]`` along ``dim`` of a
    leaf whose whole extent there is ``whole``, for a model-parallel use
    (every rank takes its own ranges, and the gradient of the leaf is the
    sum of the ranks'): this rank's tile itself where one range is exactly
    the tile, else the leaf gathered once (:func:`gather_tile`) or, for a
    whole leaf, the leaf through :func:`copy_to_model`, then narrowed."""
    s, ms = tp_rank_count()
    n = w.shape[dim]
    if n != whole:                             # this rank's tile
        if len(ranges) == 1 and tuple(ranges[0]) == (s * n, (s + 1) * n):
            return [w]
        w = gather_tile(w, dim)
    else:
        w = copy_to_model(w)
    return [w.narrow(dim, lo, hi - lo) for lo, hi in ranges]


def whole_leaf(w: torch.Tensor, whole: int, dim: int = -1) -> torch.Tensor:
    """The whole leaf for a replicated use (every rank computes the same
    thing from it): a tile is gathered with ``same_grad``, a whole leaf is
    itself."""
    if w.shape[dim] == whole:
        return w
    return gather_tile(w, dim, same_grad=True)


# ----------------------------------------------------------------------
# Mesh geometry
# ----------------------------------------------------------------------

def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _coords(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _flat_index(mesh, names) -> tuple:
    """(this rank's pod-major flat index over ``names``, their size)."""
    sizes, coords = _axis_sizes(mesh), _coords(mesh)
    idx, size = 0, 1
    for n in names:
        idx, size = idx * sizes[n] + coords[n], size * sizes[n]
    return idx, size


def _client_axes_in(mesh) -> tuple:
    return tuple(a for a in DATA_AXES if a in mesh.mesh_dim_names)


def _client_axis_size(mesh) -> int:
    sizes = _axis_sizes(mesh)
    return math.prod(sizes[a] for a in _client_axes_in(mesh))


# by the mesh's identity: DeviceMesh compares by layout, so a mesh of a
# later process group would find an earlier, destroyed group's entry
_CLIENT_GROUPS = WeakIdKeyDictionary()


def client_group(mesh=None):
    """The process group over this rank's client axes (pod x data)."""
    mesh = mesh if mesh is not None else get_mesh()
    caxes = _client_axes_in(mesh)
    if len(caxes) == 1:
        return mesh.get_group(caxes[0])
    if mesh not in _CLIENT_GROUPS:
        _CLIENT_GROUPS[mesh] = mesh[caxes]._flatten().get_group()
    return _CLIENT_GROUPS[mesh]


def model_group(mesh=None):
    """The process group over this rank's model axis."""
    mesh = mesh if mesh is not None else get_mesh()
    return mesh.get_group(MODEL_AXIS)


def client_index(mesh=None) -> int:
    """This rank's pod-major flat index over the client axes (0 off-mesh)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or not _client_axes_in(mesh):
        return 0
    return _flat_index(mesh, _client_axes_in(mesh))[0]


def model_index(mesh=None) -> int:
    """This rank's coordinate on the model axis (0 off-mesh)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 0
    return _coords(mesh)[MODEL_AXIS]


def _tiling_spec(shape, spec, mesh) -> Optional[tuple]:
    """Drop every spec entry whose dim does not tile its mesh axes; None
    when nothing survives (the degrade-gracefully contract, per dim)."""
    sizes = _axis_sizes(mesh)
    out, any_named = [], False
    for dim, name in zip(shape, spec):
        if name is None or dim % math.prod(sizes[n] for n in _names(name)):
            out.append(None)
        else:
            out.append(name)
            any_named = True
    return tuple(out) if any_named else None


def _local(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (every named dim tiles)."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        idx, size = _flat_index(mesh, _names(name))
        n = x.shape[dim] // size
        x = x.narrow(dim, idx * n, n)
    return x


SHARD_HINTS = collections.Counter()


def shard(x, spec):
    """Record the reference's model-axis hint for ``x`` and return ``x``.

    The activation the hint names is already laid out by the tensor-
    parallel model code (module docstring): a column-parallel product
    holds this rank's columns, a vocab-parallel logit block its vocab
    range.  The hint places nothing; it is counted in :data:`SHARD_HINTS`
    when a model axis > 1 is active and ``x`` tiles it.  A no-op without
    a mesh, on a model axis of 1, and where a dim does not tile."""
    mesh = get_mesh()
    if mesh is None or model_shard_count(mesh) <= 1:
        return x
    sizes = _axis_sizes(mesh)
    for dim, name in zip(x.shape, spec):
        if name is not None and dim % math.prod(sizes[n]
                                                for n in _names(name)):
            return x
    SHARD_HINTS[tuple(spec)] += 1
    return x


# ----------------------------------------------------------------------
# Client-axis sharding (the federated round engine's contract)
# ----------------------------------------------------------------------

def client_spec(ndim: int, axis: int = 0, mesh=None):
    """Spec placing dim ``axis`` (the client axis) on the mesh's data
    axes; None without a mesh or data axes.  On a multi-pod mesh it names
    the ``("pod", "data")`` pair, pod-major: contiguous client ranges per
    pod (the two-tier fold's pod groups are the same ranges)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return None
    caxes = _client_axes_in(mesh)
    if not caxes:
        return None
    spec = [None] * ndim
    spec[axis] = caxes if len(caxes) > 1 else caxes[0]
    return tuple(spec)


def client_sharding(ndim: int, axis: int = 0, mesh=None):
    """The ``DTensor`` placements of a client-stacked array, one per mesh
    dim: ``Shard(axis)`` on the client axes (nested pod-major), replicated
    on ``model``.  None when inapplicable."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh if mesh is not None else get_mesh()
    if client_spec(ndim, axis, mesh) is None:
        return None
    caxes = _client_axes_in(mesh)
    return tuple(Shard(axis) if n in caxes else Replicate()
                 for n in mesh.mesh_dim_names)


def data_shard_count(mesh=None) -> int:
    """How many ways the mesh splits the client axis: the product over
    the DATA_AXES it has (pod x data).  1 without a mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return 1
    return _client_axis_size(mesh)


def pod_count(mesh=None) -> int:
    """Size of the mesh's ``pod`` axis (1 without a mesh or pod axis)."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or POD_AXIS not in mesh.mesh_dim_names:
        return 1
    return _axis_sizes(mesh)[POD_AXIS]


def pod_data_counts(mesh=None):
    """``(pods, per_pod_shards)``; their product is
    :func:`data_shard_count`."""
    mesh = mesh if mesh is not None else get_mesh()
    p = pod_count(mesh)
    return p, data_shard_count(mesh) // p


def lane_spec(ndim: int, mesh=None):
    """Spec of the two-tier fold's ``(pods, shards, ...)`` lane tensor:
    dim 0 on ``pod``, dim 1 on ``data``.  None without data axes."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or ndim < 2:
        return None
    caxes = _client_axes_in(mesh)
    if not caxes:
        return None
    spec = [None] * ndim
    if POD_AXIS in mesh.mesh_dim_names:
        spec[0] = POD_AXIS
        rest = tuple(a for a in caxes if a != POD_AXIS)
        if rest:
            spec[1] = rest if len(rest) > 1 else rest[0]
    else:
        spec[1] = caxes if len(caxes) > 1 else caxes[0]
    return tuple(spec)


def shard_lanes(x):
    """This rank's lanes of a ``(pods, shards, ...)`` tensor; ``x`` itself
    without a mesh, without data axes, or when a lane dim does not tile."""
    mesh = get_mesh()
    spec = None if mesh is None else lane_spec(x.dim(), mesh)
    if spec is None or _tiling_spec(x.shape, spec, mesh) != spec:
        return x
    return _local(x, spec, mesh)


def client_range(n: int, mesh=None):
    """``(lo, hi)``: the contiguous range of ``n`` client-axis rows this
    rank owns; ``(0, n)`` off-mesh or when ``n`` does not tile."""
    mesh = mesh if mesh is not None else get_mesh()
    R = data_shard_count(mesh)
    if R <= 1 or n % R:
        return 0, n
    c = client_index(mesh)
    return c * n // R, (c + 1) * n // R


def client_split(n: int, mesh=None, *, chunk: Optional[int] = None,
                 groups: Optional[int] = None):
    """The one rule that splits a round over the data ranks: ``(lo, hi)``,
    the rows of the round's ``n`` client rows (and of its minibatch
    stacks) this rank builds and computes, or None where every rank runs
    the round whole.  A round splits on a mesh of R > 1 data ranks with a
    model axis of 1 when R tiles ``n``.  A streaming fold (``chunk`` its
    block size, ``groups`` its fold-group count) also needs R to tile the
    groups and blocks with no padding row, so that the rank's rows are
    exactly the blocks it folds.  The round body, the round engine and
    the segment stacks all ask this rule, so they cannot disagree."""
    mesh = mesh if mesh is not None else get_mesh()
    R = data_shard_count(mesh)
    if mesh is None or R <= 1 or model_shard_count(mesh) > 1 or n % R:
        return None
    if groups is not None and (groups % R or n % chunk):
        return None
    return client_range(n, mesh)


def gather_clients(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole client axis from every data rank's block of rows ``x``
    (the blocks of :func:`client_range`): one ``all_gather`` over the
    client group, the blocks in client order, ``(R·n, ...)``."""
    out = all_gather(x, client_group(mesh))
    return out.reshape((out.shape[0] * out.shape[1],) + tuple(out.shape[2:]))


def put_clients_by_shard(build_fn, shape, axis: int = 0, mesh=None):
    """Build this rank's block of a client-stacked array, and only it:
    ``build_fn(lo, hi)`` produces rows ``[lo, hi)`` of client axis
    ``axis``, so no process ever holds the full ``shape`` stack.  Off-mesh
    (or when the client axis does not tile) it builds all ``C`` rows."""
    lo, hi = client_range(shape[axis], mesh)
    return build_fn(lo, hi)


def shard_clients(x, axis: int = 0):
    """This rank's block of dim ``axis`` of ``x``; ``x`` itself without a
    mesh, without data axes, or when the dim does not tile."""
    lo, hi = client_range(x.shape[axis])
    return x if (lo, hi) == (0, x.shape[axis]) else x.narrow(axis, lo,
                                                             hi - lo)


def client_put(x, axis: int = 0):
    """Eager twin of :func:`shard_clients` (the same block)."""
    return shard_clients(x, axis)


def sweep_put(tree):
    """This rank's share of a sweep group's stacked operands (leading
    *scenario* axis on every leaf): the cells run one batch per data
    coordinate, contiguous and in cell order (``fl/sweep.py``).  A leaf
    whose group size does not tile the data axes stays whole, and every
    rank runs all of it."""
    from ..fl.chunking import tree_map
    return tree_map(lambda x: client_put(x, axis=0), tree)


# ----------------------------------------------------------------------
# Client x model 2D sharding (the blocked (ms, L) layout)
# ----------------------------------------------------------------------

def model_shard_count(mesh=None) -> int:
    """Size of the mesh's ``model`` axis; 1 without a mesh or the axis."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 1
    return _axis_sizes(mesh)[MODEL_AXIS]


def update_spec(ndim: int, axis: int = 0, mesh=None):
    """Spec of a client-stacked flat quantity: dim ``axis`` on the data
    axes, the last dim on ``model`` (when > 1).  None when neither
    applies."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return None
    spec = [None] * ndim
    caxes = _client_axes_in(mesh)
    if caxes and ndim > 1 and axis != ndim - 1:
        spec[axis] = caxes if len(caxes) > 1 else caxes[0]
    if model_shard_count(mesh) > 1:
        spec[-1] = MODEL_AXIS
    if all(s is None for s in spec):
        return None
    return tuple(spec)


def shard_flat(x):
    """This rank's block of a flat model-dim quantity: row ``s`` (kept as
    a (1, L) block) of the blocked ``(ms, L)`` layout, or its tile of a
    ``(D,)`` vector.  ``x`` itself without a mesh, on a model axis of 1,
    or when the dim does not tile."""
    mesh = get_mesh()
    ms = model_shard_count(mesh)
    if mesh is None or ms <= 1:
        return x
    if x.dim() == 2 and x.shape[0] == ms:
        spec = (MODEL_AXIS, None)
    else:
        spec = _tiling_spec(x.shape, (None,) * (x.dim() - 1)
                            + (MODEL_AXIS,), mesh)
    return x if spec is None else _local(x, spec, mesh)


def shard_updates(x, axis: int = 0):
    """This rank's block of a client-stacked flat matrix over both mesh
    families: dim ``axis`` on the data axes and the flat dim (the row dim
    of a blocked ``(clients, ms, L)`` matrix) on ``model``, each dropped
    where it does not tile."""
    mesh = get_mesh()
    if mesh is None:
        return x
    ms = model_shard_count(mesh)
    if x.dim() == 3 and ms > 1 and x.shape[1] == ms:
        caxes = _client_axes_in(mesh)
        cspec = None
        if caxes and x.shape[0] % _client_axis_size(mesh) == 0:
            cspec = caxes if len(caxes) > 1 else caxes[0]
        spec = (cspec, MODEL_AXIS, None)
    else:
        spec = update_spec(x.dim(), axis, mesh)
        spec = None if spec is None else _tiling_spec(x.shape, spec, mesh)
    return x if spec is None else _local(x, spec, mesh)


def _ref_path(key: str) -> str:
    """The reference's path string of a leaf: the port's flat zoo keys
    (``convert.flatten_tree``) lead with a zero-padded position."""
    return re.sub(r"^\d+:", "", key)


def _paths(tree) -> list:
    """``(reference path string, leaf)`` in JAX's leaf order."""
    return [(_ref_path("/".join(p)), leaf) for p, leaf in leaf_paths(tree)]


def _leaf_plan(path: str, shape, ms: int):
    """``(shape, size, cols, split_dim)`` of one leaf in the blocked
    layout.  ``split_dim`` is the dim the partition table shards over
    ``model`` (when it tiles ``ms``): row ``s`` then holds model rank
    ``s``'s tile.  ``None`` picks the row-major pad-and-split of the
    raveled leaf."""
    sz = int(math.prod(shape))
    for k, name in enumerate(param_partition_spec(path, len(shape))):
        if name == MODEL_AXIS and shape[k] % ms == 0:
            return shape, sz, sz // ms, k
    return shape, sz, -(-sz // ms), None


class BlockedLayout:
    """The blocked ``(ms, L)`` arrangement of a params-shaped tree, a pure
    function of ``ms`` and the leaf plans: ``L = Σ_ℓ cols_ℓ``.  It is
    built from the whole leaves' shapes (``like`` may hold meta tensors),
    never from tiles; ``D`` is the whole element count.

    ``blocks(leaves)`` arranges client-stacked fp32 leaves (in JAX's leaf
    order) into ``(n, ms, L)``; ``unravel((ms, L))`` inverts it (the zero
    padding trimmed); ``rows(flat, s)`` takes row ``s`` of a flat ``(n,
    D)`` matrix in ``core.aggregators.flatten_updates`` order without
    building the other rows.  The tensor-parallel twins read and write
    model rank ``s``'s tiles (:func:`place_params`) instead of whole
    leaves: ``local_rows(flat_tiles, s)`` is ``rows`` from the ``(n,
    D_s)`` flat matrix of the tiles, ``local_cut(flat, s)`` that flat
    matrix from a whole one, and ``unravel_local(row, s, group)`` this
    rank's tiles from its row."""

    def __init__(self, like, ms: int, batched: bool):
        self.like, self.ms = like, ms
        pairs = _paths(like)
        cut = 1 if batched else 0
        self.plans = [_leaf_plan(p, tuple(u.shape[cut:]), ms)
                      for p, u in pairs]
        self.L = sum(c for _, _, c, _ in self.plans)
        self.D = sum(sz for _, sz, _, _ in self.plans)

    def _tile_shape(self, plan) -> tuple:
        shape, _, _, k = plan
        if k is None:
            return shape
        return shape[:k] + (shape[k] // self.ms,) + shape[k + 1:]

    def local_rows(self, flat: torch.Tensor, s: int) -> torch.Tensor:
        """Row ``s`` of the blocked layout, ``(n, L)`` fp32, from the
        ``(n, D_s)`` flat matrix of model rank ``s``'s tiles (the leaves
        in JAX's leaf order): a tiled leaf's band IS its tile raveled
        (``_piece``'s ``select(1 + k, s)`` is the tile's ``narrow``), a
        whole leaf's band is its pad-and-split row ``s``."""
        n, out, o = flat.shape[0], [], 0
        for plan in self.plans:
            shape, sz, c, k = plan
            if k is not None:
                out.append(flat[:, o:o + c].to(torch.float32))
                o += c
            else:
                u = flat[:, o:o + sz].reshape((n,) + shape)
                out.append(self._piece(u.to(torch.float32), plan, s))
                o += sz
        return torch.cat(out, dim=1)

    def local_cut(self, flat: torch.Tensor, s: int) -> torch.Tensor:
        """Model rank ``s``'s ``(n, D_s)`` flat tile matrix from a whole
        ``(n, D)`` one (``flatten_updates`` order): each tiled leaf cut to
        its tile, each whole leaf kept."""
        n, out, o = flat.shape[0], [], 0
        for shape, sz, c, k in self.plans:
            u = flat[:, o:o + sz]
            if k is not None:
                nk = shape[k]
                u = u.reshape((n,) + shape).narrow(1 + k, s * (nk // self.ms),
                                                   nk // self.ms)
                u = u.reshape(n, c)
            out.append(u)
            o += sz
        return torch.cat(out, dim=1)

    def unravel_local(self, row: torch.Tensor, s: int, group):
        """Model rank ``s``'s tiles (``like``'s structure) from its row
        ``(L,)`` of the blocked layout: a tiled leaf's band reshapes to
        its tile; the whole leaves' bands of every rank come from one
        ``all_gather`` of their columns only (none when every leaf is
        tiled) and rebuild those leaves whole."""
        whole_bands, o = [], 0
        for shape, sz, c, k in self.plans:
            if k is None:
                whole_bands.append(row[o:o + c])
            o += c
        rest = None
        if whole_bands:
            rest = all_gather(torch.cat(whole_bands), group)  # (ms, Lw)
        outs, o, w = [], 0, 0
        for plan in self.plans:
            shape, sz, c, k = plan
            if k is not None:
                outs.append(row[o:o + c].reshape(self._tile_shape(plan)))
            else:
                band = rest[:, w:w + c]
                outs.append(band.reshape(self.ms * c)[:sz].reshape(shape))
                w += c
            o += c
        return unflatten_like(self.like, outs)

    def _piece(self, uf, plan, s=None):
        """(n, ms, c) of one (n, *shape) fp32 leaf; (n, c) of row s."""
        shape, sz, c, k = plan
        n, ms = uf.shape[0], self.ms
        if k is not None:
            nk = shape[k]
            uf = uf.reshape((n,) + shape[:k] + (ms, nk // ms) + shape[k + 1:])
            if s is not None:
                return uf.select(1 + k, s).reshape(n, c)
            return uf.movedim(1 + k, 1).reshape(n, ms, c)
        p = uf.reshape(n, sz)
        if c * ms != sz:
            p = torch.nn.functional.pad(p, (0, c * ms - sz))
        p = p.reshape(n, ms, c)
        return p if s is None else p[:, s]

    def blocks(self, leaves) -> torch.Tensor:
        return torch.cat([self._piece(u.to(torch.float32), plan)
                          for u, plan in zip(leaves, self.plans)], dim=2)

    def rows(self, flat: torch.Tensor, s: int) -> torch.Tensor:
        n, out, o = flat.shape[0], [], 0
        for plan in self.plans:
            shape, sz = plan[0], plan[1]
            u = flat[:, o:o + sz].reshape((n,) + shape)
            out.append(self._piece(u.to(torch.float32), plan, s))
            o += sz
        return torch.cat(out, dim=1)

    def unravel(self, vec: torch.Tensor):
        outs, o = [], 0
        for shape, sz, c, k in self.plans:
            band = vec[:, o:o + c]
            if k is not None:
                nk = shape[k]
                band = band.reshape((self.ms,) + shape[:k] + (nk // self.ms,)
                                    + shape[k + 1:])
                outs.append(band.movedim(0, k).reshape(shape))
            else:
                outs.append(band.reshape(self.ms * c)[:sz].reshape(shape))
            o += c
        return unflatten_like(self.like, outs)


def flatten_updates_sharded(updates, ms: Optional[int] = None):
    """Model-sharded twin of ``core.aggregators.flatten_updates``: the
    same per-element fp32 casts in the same leaf order, laid out as the
    blocked ``(N, ms, L)`` matrix, ``ms = model_shard_count()`` unless
    given.  Each leaf is split into ``ms`` rows along the dim the
    partition table shards (its model tiles, in tile order) or, when none
    tiles, raveled and zero-padded to a multiple of ``ms``; the leaves'
    column bands are concatenated.  The arrangement and the padding are
    the reference's bit for bit.  Returns ``(blocked, unravel)``,
    ``unravel((ms, L)) -> one client's tree``; model rank ``s`` keeps row
    ``s`` of every client."""
    ms = model_shard_count() if ms is None else ms
    layout = BlockedLayout(updates, ms, batched=True)
    flat = layout.blocks([u for _, u in _paths(updates)])
    return flat, layout.unravel


def ravel_sharded(tree, ms: Optional[int] = None):
    """One-client :func:`flatten_updates_sharded`: ``tree`` raveled into
    the blocked ``(ms, L)`` fp32 layout, with the same column offsets and
    rows, so guides and updates align element for element."""
    ms = model_shard_count() if ms is None else ms
    layout = BlockedLayout(tree, ms, batched=False)
    return layout.blocks([u.unsqueeze(0) for _, u in _paths(tree)])[0]


def blocked_layout(params, ms: Optional[int] = None) -> BlockedLayout:
    """The :class:`BlockedLayout` of an unbatched params tree."""
    ms = model_shard_count() if ms is None else ms
    return BlockedLayout(params, ms, batched=False)


# ----------------------------------------------------------------------
# Parameter partition rules (megatron-style + expert parallel), keyed on
# substrings of the reference's parameter path
# ----------------------------------------------------------------------

def _last(nd, axis, over_first=False):
    spec = [None] * nd
    if over_first:
        spec[-2 if nd >= 2 else 0] = MODEL_AXIS   # embed (.., V, D): V
    else:
        spec[-1] = axis
    return tuple(spec)


def _secondlast(nd, axis):
    spec = [None] * nd
    spec[-2 if nd >= 2 else -1] = axis
    return tuple(spec)


def _expert(nd):
    # routed expert weights are (n_groups?, E, D, F): the expert dim
    spec = [None] * nd
    spec[-3 if nd >= 3 else 0] = MODEL_AXIS
    return tuple(spec)


_RULES = (
    ("embed",    lambda nd: _last(nd, None, over_first=True)),   # (V, D)
    ("lm_head",  lambda nd: _last(nd, MODEL_AXIS)),              # (D, V)
    ("wq",       lambda nd: _last(nd, MODEL_AXIS)),              # (D, H*dh)
    ("wk",       lambda nd: _last(nd, MODEL_AXIS)),
    ("wv",       lambda nd: _last(nd, MODEL_AXIS)),
    ("wo",       lambda nd: _secondlast(nd, MODEL_AXIS)),        # (H*dh, D)
    ("w_up",     lambda nd: _last(nd, MODEL_AXIS)),              # (D, F)
    ("w_gate",   lambda nd: _last(nd, MODEL_AXIS)),
    ("w_down",   lambda nd: _secondlast(nd, MODEL_AXIS)),        # (F, D)
    ("router",   lambda nd: _last(nd, None)),
    ("routed",   lambda nd: _expert(nd)),                        # (.., E, D, F)
    ("shared",   lambda nd: _last(nd, MODEL_AXIS)),
    ("in_proj",  lambda nd: _last(nd, MODEL_AXIS)),              # (D, 2*di)
    ("conv_w",   lambda nd: _last(nd, MODEL_AXIS)),              # (k, di)
    ("conv_b",   lambda nd: _last(nd, MODEL_AXIS)),
    ("x_proj",   lambda nd: _secondlast(nd, MODEL_AXIS)),        # (di, R+2S)
    ("dt_proj",  lambda nd: _last(nd, MODEL_AXIS)),              # (R, di)
    ("A_log",    lambda nd: _secondlast(nd, MODEL_AXIS)),        # (di, S)
    ("D_skip",   lambda nd: _last(nd, MODEL_AXIS)),              # (di,)
    ("dt_bias",  lambda nd: _last(nd, MODEL_AXIS)),
    ("out_proj", lambda nd: _secondlast(nd, MODEL_AXIS)),        # (di, D)
)


def param_partition_spec(path: str, ndim: int) -> tuple:
    """The spec of the leaf at the reference's ``path``: the first rule
    whose key is a substring of it; ``()`` (replicated) for norms, biases
    and scalars."""
    for key, make_spec in _RULES:
        if key in path:
            return make_spec(ndim)
    return ()


def _map_paths(fn, tree, prefix=()):
    """``fn(reference path, leaf)`` over a tree, structure kept."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_ref_path("/".join(prefix)), tree)


def partition_pytree(params):
    """The params tree with each leaf's spec in its place."""
    return _map_paths(lambda p, leaf: param_partition_spec(p, leaf.dim()),
                      params)


def param_shardings(params, mesh=None):
    """The partition table's split of each leaf on the client x model mesh:
    its spec with every dim that does not tile dropped (``()`` where
    nothing tiles), replicated over the client axes (every client trains
    the same parameters).  :func:`place_params` cuts each leaf to it.
    None without a mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return None

    def one(path, leaf):
        spec = param_partition_spec(path, leaf.dim())
        s = _tiling_spec(leaf.shape, spec, mesh) if spec else None
        return () if s is None else s
    return _map_paths(one, params)


def _model_split(path: str, shape, ms: int):
    """The dim the partition table tiles over ``model`` (``ms`` > 1), or
    None: the leaf stays whole on every rank."""
    return _leaf_plan(path, tuple(shape), ms)[3]


def place_params(params, mesh=None):
    """The reference's placement of params on the mesh: on a model axis >
    1 each leaf that the partition table tiles becomes this rank's tile
    along its split dim, a fresh contiguous tensor (the whole leaf can be
    freed); every other leaf is kept as it is.  The identity without a
    mesh or on a model axis of 1.  ``params`` is a tree or the zoo's flat
    dict; meta leaves give meta tiles."""
    mesh = mesh if mesh is not None else get_mesh()
    ms = model_shard_count(mesh)
    if mesh is None or ms <= 1:
        return params
    s = model_index(mesh)

    def one(path, leaf):
        k = _model_split(path, leaf.shape, ms)
        if k is None:
            return leaf
        n = leaf.shape[k] // ms
        return leaf.narrow(k, s * n, n).clone(
            memory_format=torch.contiguous_format)
    return _map_paths(one, params)


def shard_params(params, like=None):
    """The in-round twin of :func:`place_params`: checks that every leaf
    of ``params`` still has its tile's shape under the active mesh
    (``like`` holds the whole shapes; meta tensors do) and returns
    ``params``.  The identity without a mesh or on a model axis of 1."""
    mesh = get_mesh()
    if mesh is None or model_shard_count(mesh) <= 1 or like is None:
        return params
    want = [leaf.shape for _, leaf in _paths(place_params(like, mesh))]
    got = _paths(params)
    for (path, leaf), shape in zip(got, want):
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(
                f"shard_params: {path} has shape {tuple(leaf.shape)}, but "
                f"this rank's tile of it is {tuple(shape)}")
    return params


def gather_params(tiles, like, mesh=None):
    """The whole params from every model rank's tiles: one ``all_gather``
    a tiled leaf over the model group, the tiles joined along the split
    dim in rank order; a whole leaf is kept.  ``like`` holds the whole
    shapes.  The identity without a mesh or on a model axis of 1."""
    mesh = mesh if mesh is not None else get_mesh()
    ms = model_shard_count(mesh)
    if mesh is None or ms <= 1:
        return tiles
    group = model_group(mesh)
    splits = {p: _model_split(p, leaf.shape, ms) for p, leaf in _paths(like)}

    def one(path, leaf):
        k = splits[path]
        if k is None:
            return leaf
        return torch.cat(all_gather(leaf, group).unbind(0), dim=k)
    return _map_paths(one, tiles)
