"""``launch.train.make_fl_round_step`` over gloo ranks: the twins of
``tests/test_sharded_step.py``'s round-step tests, on the SMOKE configs.

The port runs in 8 ranks (``launch.mesh.spawn_local``: a ``FileStore``
under ``tmp_path``, one torch thread a rank, a time limit on the join),
each rank on its tiles of the params (``sharding.place_params``; the
step's results gathered with ``sharding.gather_params``); inputs are made
with numpy from a seed.  The reference's gemma-2b step runs in a subprocess on
8 forced host devices on the same params and inputs (``.npz`` both ways).

* gemma-2b on 4 x 2, fp32: the reference's mask (sign flip and x5 caught)
  and ``kept``, params within 1e-5·max|x| + 1e-6 of each leaf (every rank
  the same bits), and the loss falls over 5 more steps.
* deepseek-moe-16b on (2, 2, 2): ``kept == 3`` with one sign flipper.
* Median mode on 4 x 2: the loss falls over 5 steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.convert import leaf_paths, unflatten_like
from repro_torch.launch.mesh import (make_host_mesh, make_host_pod_mesh,
                                     n_clients, spawn_local)
from repro_torch.launch.train import make_fl_round_step

RANK_TIMEOUT = 150
SEED = 22


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _inputs(vocab, B, S, nc, byz, guide_from_tokens=False, seed=SEED):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S), dtype=np.int32)
    guide = tokens.reshape(nc, B // nc, S)[:, :1] if guide_from_tokens \
        else rng.integers(0, vocab, (nc, 1, S), dtype=np.int32)
    return {"tokens": tokens, "guide_tokens": np.ascontiguousarray(guide),
            "byz_kind": np.asarray(byz, np.int32),
            "rng": np.zeros((2,), np.int64)}


REF_STEP = """
import dataclasses
import jax.numpy as jnp
from jax.sharding import NamedSharding
from repro import configs, models
from repro.core.diversefl import DiverseFLConfig
from repro.launch.train import make_fl_round_step
from repro.sharding import partition_pytree

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = dataclasses.replace(configs.get("gemma-2b", smoke=True),
                          dtype="float32", param_dtype="float32")
params = models.init(jax.random.PRNGKey(0), cfg)
for i, leaf in enumerate(jax.tree.leaves(params)):
    OUT[f"p0_{i:03d}"] = np.asarray(leaf)
params = jax.device_put(params, jax.tree.map(
    lambda s: NamedSharding(mesh, s), partition_pytree(params)))
inputs = {k: jnp.asarray(IN[k].astype(np.uint32) if k == "rng" else IN[k])
          for k in ("tokens", "guide_tokens", "byz_kind", "rng")}
step = make_fl_round_step(cfg, mesh, DiverseFLConfig(), lr=0.1,
                          donate=False)
p, m = step(params, inputs)
for i, leaf in enumerate(jax.tree.leaves(p)):
    OUT[f"p1_{i:03d}"] = np.asarray(leaf)
for k in ("mask", "kept", "loss", "c1", "c2"):
    OUT[k] = np.asarray(m[k])
"""


def _as_torch(inputs):
    return {k: torch.from_numpy(np.asarray(v)).long() if k != "byz_kind"
            else torch.from_numpy(np.asarray(v)) for k, v in inputs.items()}


def _specs(tree):
    """The spec tuples of a ``param_shardings`` tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _specs(v)
    else:
        yield tree


def _gemma_ranks(rank, world, p0_leaves, inputs):
    """diversefl from the reference's params (one step, then five more),
    and median mode, on the 4 x 2 mesh."""
    cfg = _fp32(configs.get("gemma-2b", smoke=True))
    mesh = make_host_mesh(4, 2, device="cpu")
    like = models.init(None, cfg, "meta")
    p0 = unflatten_like(like, [torch.from_numpy(v) for v in p0_leaves])
    # the partition table splits some leaves on this mesh's model axis,
    # and each rank holds its tiles of them
    split = sum(sharding.MODEL_AXIS in s
                for s in _specs(sharding.param_shardings(p0, mesh)))
    tiles = sharding.place_params(p0, mesh)
    assert sum(a.shape != b.shape for (_, a), (_, b) in
               zip(leaf_paths(tiles), leaf_paths(p0))) > 0
    x = _as_torch(inputs)
    out = {"split": split}
    step = make_fl_round_step(cfg, mesh, lr=0.1, donate=False)
    p, m = step(tiles, x)
    out["p1"] = [v.numpy() for _, v in leaf_paths(
        sharding.gather_params(p, like, mesh))]
    out["m1"] = {k: v.numpy() for k, v in m.items()}
    for _ in range(5):
        p, m = step(p, x)
    out["loss_after"] = float(m["loss"])
    med = make_fl_round_step(cfg, mesh, lr=0.1, donate=False,
                             robust_mode="median")
    tm = _as_torch(_inputs(cfg.vocab_size, 8, 64, 4, [0, 1, 0, 0],
                           guide_from_tokens=True))
    p, m = med(tiles, tm)
    out["med0"] = float(m["loss"])
    for _ in range(5):
        p, m = med(p, tm)
    out["med5"] = float(m["loss"])
    out["med_kept"] = float(m["kept"])
    return out


def test_gemma_round_step_is_the_references_and_learns(tmp_path):
    from test_torch_s6b_layout import run_reference
    cfg = configs.get("gemma-2b", smoke=True)
    inputs = _inputs(cfg.vocab_size, 8, 64, 4, [0, 1, 3, 0])
    ref = run_reference(REF_STEP, tmp_path, inputs, devices=8)
    n = len(leaf_paths(models.init(None, cfg, "meta")))
    p0 = [ref[f"p0_{i:03d}"] for i in range(n)]
    ranks = spawn_local(_gemma_ranks, 8, (p0, inputs), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    assert list(ref["mask"]) == [True, False, False, True]
    for r in ranks:
        assert r["split"] > 0
        m = r["m1"]
        assert list(m["mask"]) == list(ref["mask"])
        assert float(m["kept"]) == float(ref["kept"]) == 2.0
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["c2"], ref["c2"], rtol=1e-4)
        for i, g in enumerate(r["p1"]):
            w = ref[f"p1_{i:03d}"]
            tol = 1e-5 * np.abs(w).max() + 1e-6
            assert np.abs(g - w).max() <= tol, (i, np.abs(g - w).max())
            assert np.array_equal(g, ranks[0]["p1"][i])
        assert r["loss_after"] < float(m["loss"])
        assert r["med5"] < r["med0"] and r["med_kept"] == 4.0


def _moe_rank(rank, world):
    cfg = configs.get("deepseek-moe-16b", smoke=True)
    mesh = make_host_pod_mesh(2, 2, 2, device="cpu")
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = _as_torch(_inputs(cfg.vocab_size, 8, 32, 4, [0, 0, 1, 0]))
    step = make_fl_round_step(cfg, mesh, lr=0.05, donate=False)
    _, m = step(params, x)
    return {"kept": float(m["kept"]), "nc": n_clients(mesh),
            "mask": m["mask"].tolist()}


def test_multipod_round_step_keeps_the_honest_clients(tmp_path):
    ranks = spawn_local(_moe_rank, 8, (), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    for r in ranks:
        assert r["nc"] == 4 and r["kept"] == 3.0
        assert r["mask"] == [True, True, False, True]

