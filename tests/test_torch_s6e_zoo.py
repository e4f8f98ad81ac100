"""The zoo's forward and backward split over the model axis, per family,
against the port's meshless run and the reference's GSPMD run.

Every zoo family's SMOKE config in fp32 (and ``head-cut``, whose 3 heads
of 16 split into tiles of one and a half heads, as gemma-2b's 8 heads do
on a 16-way axis), at 1 x 2 and 4 x 2: the params drawn once, the
tokens (and the frames or patches an encoder or cross layer reads) made
with numpy from a seed.  The port runs on gloo ranks
(``launch.mesh.spawn_local``, one torch thread a rank), each on its tiles
(``sharding.place_params``): ``models.loss_fn`` and its gradient by
``torch.autograd``.  The reference runs in a subprocess on 2 or 8 forced
XLA host devices, its params placed by its own ``param_shardings``, and
``jax.value_and_grad`` of its ``loss_fn`` under ``jit`` (GSPMD splits
it).  Held:

* every gradient has its tile's shape, and the loss is the same on every
  rank;
* the loss within rtol 1e-5 of the meshless run's and the reference's;
  each gradient leaf within ``1e-4·max|g| + 1e-3·|g|`` of that leaf of the
  meshless gradient, cut to the rank's tile, and of the reference's (two
  reduction orders in each, as ``tests/test_torch_s6a_zoo.py`` holds the
  port to the reference);
* the vocab-parallel embedding bitwise the meshless lookup.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.convert import flatten_tree, unflatten_like
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.models import ModelConfig
from repro_torch.models.model import _embed
from repro_torch.sharding import api

RANK_TIMEOUT = 240
SEED = 25
B, S = 2, 12
HEAD_CUT = dict(name="head-cut", n_layers=2, d_model=48, n_heads=3,
                n_kv_heads=1, head_dim=16, d_ff=96, vocab_size=64,
                attn_direct_max=16)
NAMES = tuple(configs.all_arch_ids()) + ("head-cut",)
MESHES = {"1x2": (1, 2), "4x2": (4, 2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    cfg = ModelConfig(**HEAD_CUT) if name == "head-cut" \
        else dataclasses.replace(configs.get(name, smoke=True),
                                 attn_direct_max=16)
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _inputs():
    """Params (leaves in JAX's leaf order) and batches of every config,
    as numpy arrays keyed ``{name}/...``."""
    rng = np.random.default_rng(SEED)
    out = {}
    for name in NAMES:
        cfg = _cfg(name)
        p = models.init(torch.Generator().manual_seed(SEED), cfg, "cpu")
        for g in p["groups"]:
            if "xgate" in g:
                g["xgate"].fill_(0.5)      # tanh(0) = 0 hides the layer
        for i, v in enumerate(flatten_tree(p).values()):
            out[f"{name}/p{i:03d}"] = v.numpy()
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
        if cfg.is_enc_dec:
            out[f"{name}/enc_emb"] = rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        elif cfg.has_cross:
            out[f"{name}/cross_emb"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _batch(inputs, name):
    return {k: torch.from_numpy(inputs[f"{name}/{k}"]).long()
            if k == "tokens" else torch.from_numpy(inputs[f"{name}/{k}"])
            for k in ("tokens", "enc_emb", "cross_emb")
            if f"{name}/{k}" in inputs}


def _params(inputs, name):
    like = models.init(None, _cfg(name), "meta")
    n = len(flatten_tree(like))
    return unflatten_like(like, [torch.from_numpy(inputs[f"{name}/p{i:03d}"])
                                 for i in range(n)])


def _loss_and_grad(params, cfg, batch):
    flat = flatten_tree(params)
    leaves = [v.detach().requires_grad_(True) for v in flat.values()]
    loss = models.loss_fn(unflatten_like(params, leaves), cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(flat.items(), grads)}


def _rank(rank, world, inputs, shape):
    mesh = make_host_mesh(*shape, device="cpu")
    out = {"s": sharding.model_index(mesh)}
    for name in NAMES:
        cfg, batch = _cfg(name), _batch(inputs, name)
        params = _params(inputs, name)
        with sharding.use_mesh(mesh):
            tiles = sharding.place_params(params, mesh)
            out[name] = _loss_and_grad(tiles, cfg, batch)
            with torch.no_grad():
                out[name, "embed"] = _embed(tiles, cfg, batch["tokens"])
    return out


REF = """
import dataclasses
import jax.numpy as jnp
from repro import configs, models
from repro.models.config import ModelConfig
from repro.sharding import param_shardings, use_mesh

HEAD_CUT = dict(name="head-cut", n_layers=2, d_model=48, n_heads=3,
                n_kv_heads=1, head_dim=16, d_ff=96, vocab_size=64,
                attn_direct_max=16)
data = int(IN["data"])
mesh = jax.make_mesh((data, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for name in [str(n) for n in IN["names"]]:
    cfg = ModelConfig(**HEAD_CUT) if name == "head-cut" else \\
        dataclasses.replace(configs.get(name, smoke=True),
                            attn_direct_max=16)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    tdef = jax.tree.structure(models.init(jax.random.PRNGKey(0), cfg))
    n = tdef.num_leaves
    p = jax.tree.unflatten(tdef, [jnp.asarray(IN[f"{name}/p{i:03d}"])
                                  for i in range(n)])
    batch = {k: jnp.asarray(IN[f"{name}/{k}"])
             for k in ("tokens", "enc_emb", "cross_emb")
             if f"{name}/{k}" in IN}
    with use_mesh(mesh):
        p = jax.device_put(p, param_shardings(p, mesh))
        loss, g = jax.jit(jax.value_and_grad(
            lambda q: models.loss_fn(q, cfg, batch)))(p)
    OUT[f"{name}/loss"] = np.asarray(loss)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        OUT[f"{name}/g{i:03d}"] = np.asarray(leaf)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The meshless port, and per mesh the ranks' and the reference's
    loss and gradients."""
    from test_torch_s6b_layout import run_reference
    inputs = _inputs()
    base = {}
    for name in NAMES:
        base[name] = _loss_and_grad(_params(inputs, name), _cfg(name),
                                    _batch(inputs, name))
        with torch.no_grad():
            base[name, "embed"] = _embed(_params(inputs, name), _cfg(name),
                                         _batch(inputs, name)["tokens"])
    out = {}
    for mesh_name, shape in MESHES.items():
        tmp = tmp_path_factory.mktemp(mesh_name)
        ref = run_reference(REF, tmp, {**inputs, "data": np.asarray(shape[0]),
                                       "names": np.asarray(NAMES)},
                            devices=shape[0] * shape[1], timeout=600)
        ranks = spawn_local(_rank, shape[0] * shape[1], (inputs, shape),
                            timeout=RANK_TIMEOUT, workdir=tmp)
        out[mesh_name] = (ref, ranks)
    return base, out


def _tile(g, key, s, ms=2):
    d = api._model_split(api._ref_path(key), g.shape, ms)
    if d is None:
        return g
    n = g.shape[d] // ms
    return g.narrow(d, s * n, n)


def _close(got, want, what):
    w = torch.as_tensor(np.asarray(want))
    tol = 1e-4 * w.abs().max() + 1e-3 * w.abs()
    assert got.shape == w.shape, what
    assert ((got - w).abs() <= tol + 1e-12).all(), \
        (what, float((got - w).abs().max()), float(w.abs().max()))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_split_loss_and_grad_match_meshless_and_the_reference(
        runs, name, mesh_name):
    base, out = runs
    ref, ranks = out[mesh_name]
    want_loss, want_g = base[name]
    assert len({r[name][0] for r in ranks}) == 1        # the same loss
    np.testing.assert_allclose(ranks[0][name][0], want_loss, rtol=1e-5)
    np.testing.assert_allclose(ranks[0][name][0], float(ref[f"{name}/loss"]),
                               rtol=1e-5)
    n_tiled = 0
    for r in ranks:
        s = r["s"]
        for i, (k, g) in enumerate(r[name][1].items()):
            whole = want_g[k]
            cut = _tile(whole, k, s)
            n_tiled += cut.shape != whole.shape
            assert g.shape == cut.shape, k          # the tile's gradient
            _close(g, cut.numpy(), (name, k, "meshless"))
            _close(g, _tile(torch.from_numpy(ref[f"{name}/g{i:03d}"]), k,
                            s).numpy(), (name, k, "reference"))
        # the vocab-parallel embedding: one nonzero term a token
        assert torch.equal(r[name, "embed"], base[name, "embed"])
    assert n_tiled > 0
