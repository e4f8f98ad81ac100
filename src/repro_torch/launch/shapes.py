"""The assigned input shapes and their stand-ins for a dry run.

Every model input is produced as a meta-device tensor (shape and dtype,
no storage) beside its placement on the mesh, ``(mesh, spec)`` with the
reference's ``PartitionSpec`` entries as a tuple, or ``None`` without a
mesh: :func:`sds` is the one helper that makes them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from .mesh import client_axes, n_clients


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for the sub-quadratic archs (SSM, hybrid, sliding
    window)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


def _batch_axes(mesh, batch: int):
    """Largest prefix of the client axes that evenly divides the batch."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes, rem = [], batch
    for a in client_axes(mesh):
        if rem % sizes[a]:
            break
        axes.append(a)
        rem //= sizes[a]
    return tuple(axes) if axes else None


def sds(shape, dtype, mesh=None, spec=None):
    """``(meta tensor, placement)``: the placement is ``(mesh, spec)``
    (``()`` replicates) or None without a mesh."""
    s = torch.empty(tuple(shape), dtype=dtype, device="meta")
    if mesh is None:
        return s, None
    return s, (mesh, tuple(spec) if spec is not None else ())


# ----------------------------------------------------------------------
# Train inputs (FL round step)
# ----------------------------------------------------------------------

def train_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                 guide_batch: int = 1):
    """``({name: meta tensor}, {name: placement})``:

    - tokens       (B, S)              split over the client axes
    - guide_tokens (n_clients, gb, S)  one enclave sample batch per client
    - byz_kind     (n_clients,) int32  per-client simulated fault
    - rng          (2,) int64          round seed
    - the encoder/cross embeddings where the arch needs them
    """
    nc = n_clients(mesh)
    caxes = client_axes(mesh)
    B, S = shape.batch, shape.seq
    specs, placements = {}, {}

    def add(name, shp, dtype, spec):
        specs[name], placements[name] = sds(shp, dtype, mesh, spec)

    add("tokens", (B, S), torch.int32, (caxes, None))
    add("guide_tokens", (nc, guide_batch, S), torch.int32,
        (caxes, None, None))
    add("byz_kind", (nc,), torch.int32, (caxes,))
    add("rng", (2,), torch.int64, ())
    if cfg.is_enc_dec:
        add("enc_emb", (B, cfg.enc_seq, cfg.d_model), torch.bfloat16,
            (caxes, None, None))
        add("guide_enc_emb", (nc, guide_batch, cfg.enc_seq, cfg.d_model),
            torch.bfloat16, (caxes, None, None, None))
    elif cfg.has_cross:
        add("cross_emb", (B, cfg.n_patches, cfg.d_model), torch.bfloat16,
            (caxes, None, None))
        add("guide_cross_emb", (nc, guide_batch, cfg.n_patches, cfg.d_model),
            torch.bfloat16, (caxes, None, None, None))
    return specs, placements


# ----------------------------------------------------------------------
# Serve inputs (single-token decode against a seq-long cache)
# ----------------------------------------------------------------------

def _cache_spec_tree(cfg: ModelConfig, cache, mesh, batch: int):
    """Specs of a cache tree: the batch over the client axes when it
    divides, otherwise the long (seq) dim of a KV cache over them
    (flash-decoding style); the KV heads on ``model`` where the heads
    split and ``ms`` tiles the KV heads, the SSM and conv states' d_inner
    on ``model`` where the mixer is channel-parallel."""
    baxes = _batch_axes(mesh, batch)
    caxes = client_axes(mesh)
    ms = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    heads = ms > 1 and (cfg.n_heads * cfg.head_dim) % ms == 0 \
        and cfg.n_kv_heads % ms == 0
    chans = ms > 1 and cfg.d_inner % ms == 0

    def spec_for(key, leaf):
        nd = leaf.dim()
        if "conv" in key:                      # (G,B,dc,di)
            return (None,) * (nd - 1) + ("model" if chans else None,)
        if "ssm" in key:                       # (G,B,di,S)
            return (None,) * (nd - 2) + ("model" if chans else None, None)
        # kv caches: (G,B,C,K,dh) or (B,C,K,dh)
        spec = [None] * nd
        if baxes:
            spec[nd - 4] = baxes
        elif leaf.shape[nd - 3] >= 4096:
            spec[nd - 3] = caxes               # seq-sharded long cache
        if heads:
            spec[nd - 2] = "model"
        return tuple(spec)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, path + (str(i),)) for i, v in enumerate(t))
        return spec_for("/".join(path), t)
    return walk(cache, ())


def serve_inputs(cfg: ModelConfig, shape: InputShape, mesh):
    """token (B, 1), the cache tree (meta tensors) and cache_index (), with
    their placements.  The cache is this rank's, as the split layers write
    it (``models.init_cache`` under the mesh): its KV heads and Mamba
    channels on a model axis > 1."""
    from ..models import model as _model
    from ..sharding import use_mesh
    B, S = shape.batch, shape.seq
    baxes = _batch_axes(mesh, B)
    ms = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    with use_mesh(None):
        whole = _model.init_cache(cfg, B, S, device="meta")
    specs = _cache_spec_tree(cfg, whole, mesh, B)
    local_kv = None
    if ms > 1 and (cfg.n_heads * cfg.head_dim) % ms == 0 \
            and cfg.n_kv_heads % ms:
        # the KV heads this rank's query heads read (gemma-2b's one)
        from ..models.attention import kv_heads
        with use_mesh(mesh):
            local_kv = kv_heads(cfg)

    def cut(t, spec, key=""):
        if isinstance(t, dict):
            return {k: cut(t[k], spec[k], k) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(cut(a, b) for a, b in zip(t, spec))
        shp = [n // ms if name == "model" else n
               for n, name in zip(t.shape, spec)]
        if local_kv is not None and key in ("k", "v"):
            shp[-2] = local_kv
        return torch.empty(shp, dtype=t.dtype, device="meta")
    cache = cut(whole, specs)
    cache_pl = _map_specs(specs, mesh)
    tok, tok_pl = sds((B, 1), torch.int32, mesh, (baxes, None))
    idx, idx_pl = sds((), torch.int32, mesh, ())
    return ({"token": tok, "cache": cache, "cache_index": idx},
            {"token": tok_pl, "cache": cache_pl, "cache_index": idx_pl})


def _map_specs(specs, mesh):
    """A tree of spec tuples -> the same tree of ``(mesh, spec)``.  Spec
    tuples hold names, name tuples or None; container tuples hold
    dicts."""
    if isinstance(specs, dict):
        return {k: _map_specs(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                   and isinstance(specs[0], dict)):
        return type(specs)(_map_specs(v, mesh) for v in specs)
    return (mesh, specs)
