"""Serving: the batched prefill forward and one greedy decode step
against the KV/SSM cache.  The counterpart of ``repro/launch/serve.py``.

Each takes the reference's ``mesh`` (a ``DeviceMesh`` or None) and runs
under ``sharding.use_mesh(mesh)``: every rank of the mesh calls it with
the same tokens and its own tiles of the params
(``sharding.place_params(params, mesh)``; whole params off a model axis >
1).  The layers run split over the model group, the cache holds the
rank's KV heads and Mamba channels (``models.init_cache`` under the mesh,
or ``launch.shapes.serve_inputs``), and every rank gets the whole logits
and the same next tokens.  Decode reads nothing on the host.  Each runs
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch

from .. import models
from ..sharding import use_mesh


def make_serve_step(cfg, mesh=None, donate_cache: bool = True):
    """serve_step(params, token (B,1), cache, cache_index)
       -> (next_token (B,1) int32, new_cache).

    Greedy: the next token is the argmax of the step's logits.  The cache
    is updated IN PLACE (the KV entries at ``cache_index``, the SSM and
    conv states) and new_cache holds the same tensors: the reference
    donates the cache to this step (``donate_argnums=(2,)``), so no
    caller reads its old contents.  ``donate_cache=False`` updates a copy
    and leaves the caller's cache untouched."""

    @torch.inference_mode()
    def serve_fn(params, token, cache, cache_index):
        if not donate_cache:
            cache = _clone(cache)
        with use_mesh(mesh):
            lg, new_cache = models.decode_step(params, cfg, token, cache,
                                               cache_index)
        return torch.argmax(lg, dim=-1).to(torch.int32), new_cache

    return serve_fn


def make_prefill(cfg, mesh=None):
    """prefill(params, tokens (B,S), [enc_emb | cross_emb]) ->
    (last-position logits (B,1,V), cache).  The cache is the forward's:
    K/V of every position for the attention layers, the conv inputs and
    final SSM state for Mamba, and each cross layer's K/V over the
    encoder's output (``enc_emb``, enc-dec archs) or the patch embeddings
    (``cross_emb``, VLMs), which decode reads as they are."""

    @torch.inference_mode()
    def prefill_fn(params, tokens, enc_emb=None, cross_emb=None):
        with use_mesh(mesh):
            out = models.apply(params, cfg, tokens, enc_emb=enc_emb,
                               cross_emb=cross_emb, want_cache=True)
            return models.logits(params, cfg, out["hidden"][:, -1:, :]), \
                out["cache"]

    return prefill_fn


def make_forward(cfg, mesh=None):
    """forward(params, tokens (B,S), [enc_emb | cross_emb]) -> the mean
    next-token loss of the full-sequence forward plus the MoE layers'
    load-balance losses (fp32 scalar)."""

    @torch.inference_mode()
    def fwd(params, tokens, enc_emb=None, cross_emb=None):
        batch = {"tokens": tokens}
        if enc_emb is not None:
            batch["enc_emb"] = enc_emb
        if cross_emb is not None:
            batch["cross_emb"] = cross_emb
        with use_mesh(mesh):
            return models.loss_fn(params, cfg, batch)

    return fwd


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()
