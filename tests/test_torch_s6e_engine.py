"""The round engine with tensor-parallel params on a model axis of 2.

zoo-tiny (2 layers, d 32, vocab 64, seq 8; 4 clients, f = 1 under
sign_flip, 4 rounds of streaming diversefl, eval every 2) in fp32 on 8
gloo ranks (a 4 x 2 mesh; ``launch.mesh.spawn_local``, one torch thread a
rank), against the same run in one process, the minibatch draws given to
both.  ``tests/test_torch_s6b_engine.py`` holds the same config's 4 x 2
run against the reference's 4 x 2 run.  Held:

* the carry holds the rank's tiles: its param bytes are the tiles' that
  ``sharding.param_shardings`` gives, below the whole params';
* masks, C1 signs and C2 passes, and accuracy equal the meshless run's;
  params within 1e-5·max|x| + 1e-6 of each leaf; every rank returns the
  same whole params, bit for bit;
* the collectives of a round, by kind: no ``all_gather`` over the model
  group carries L (a rank's row) or more elements; the round's delta
  crosses the model group as one ``all_gather`` of the replicated
  leaves' columns; the whole params are gathered once, at the end;
* ``ZooModel.loss``'s ridge term counts each whole leaf once: the loss
  with ``l2`` on the tiles equals the meshless loss.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.fl import (FLConfig, RoundEngine, make_zoo_federation,
                            zoo_model)
from repro_torch.fl import simulator as sim
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.models import ModelConfig

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16,
            dtype="float32", param_dtype="float32")
CFG = dict(n_clients=4, f=1, rounds=4, local_steps=1, batch_size=4, l2=0.0,
           aggregator="diversefl", streaming=True, stream_shards=1,
           eval_every=2, seed=0)
SEQ, PER, LR = 8, 16, 0.05
RANK_TIMEOUT = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup():
    model = zoo_model(ModelConfig(**TINY), seq_len=SEQ)
    cfg = FLConfig(**CFG, attack=AttackConfig(kind="sign_flip"))
    fed = make_zoo_federation(model, cfg, torch.Generator().manual_seed(3),
                              per_client=PER, n_test=32, device="cpu")
    p0 = model.init(torch.Generator().manual_seed(1), "cpu")
    idx = torch.randint(0, PER, (cfg.rounds, cfg.n_clients, cfg.batch_size),
                        generator=torch.Generator().manual_seed(2))
    return model, cfg, fed, p0, idx


def _run(mesh):
    model, cfg, fed, p0, idx = _setup()
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    lrs = torch.full((cfg.rounds,), LR)
    out = {}
    carry = eng.init_carry(p0)
    out["carry_bytes"] = sum(v.numel() * v.element_size()
                             for v in carry.values())
    out["tile_shapes"] = [tuple(v.shape) for k, v in carry.items()
                          if v.shape != model.like[k].shape]
    before = sharding.collective_counts()
    with sharding.record_collectives() as recs:
        carry, _ = eng.run_segment(carry, gen, lrs,
                                   draws={"batch_idx": idx})
    out["round_counts"] = {k: v - before[k] for k, v in
                           sharding.collective_counts().items()}
    out["round_recs"] = [(r["kind"], r["shape"], r["group_size"])
                         for r in recs]
    with sharding.record_collectives() as recs:
        p, _, met, _ = eng.run_training(
            p0, torch.Generator().manual_seed(0), lrs,
            draws={"batch_idx": idx})
    out["run_gathers"] = [r["shape"] for r in recs
                          if r["kind"] == "all-gather"]
    host = sim.host_sync(met)
    out.update(params=p, **{k: np.asarray(host[k]) for k in
                            ("acc", "c1c2", "mask_tpr", "mask_fpr")})
    # the ridge term on the tiles, against the meshless value
    x, y = fed.test_x[:4], fed.test_y[:4]
    with sharding.use_mesh(mesh):
        out["l2_loss"] = float(model.loss(carry, x, y, l2=0.5))
    return out


def _rank(rank, world):
    mesh = make_host_mesh(4, 2, device="cpu")
    out = _run(mesh)
    out["s"] = sharding.model_index(mesh)
    model = _setup()[0]
    layout = sharding.blocked_layout(model.like, 2)
    out["L"] = layout.L
    out["whole_cols"] = sum(c for _, _, c, k in layout.plans if k is None)
    shard = sharding.param_shardings(model.like, mesh)
    out["tile_bytes"] = sum(
        v.numel() * v.element_size() // math.prod(
            dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
            for n in shard[k] if n is not None)
        for k, v in model.like.items())
    return out


def test_tensor_parallel_engine_on_4x2(tmp_path):
    base = _run(None)
    ranks = spawn_local(_rank, 8, (), timeout=RANK_TIMEOUT, workdir=tmp_path)
    whole_bytes = sum(v.numel() * v.element_size()
                      for v in base["params"].values())
    assert base["carry_bytes"] == whole_bytes
    assert base["round_counts"] == {"all_reduce": 0, "all_gather": 0}
    for r in ranks:
        assert r["carry_bytes"] == r["tile_bytes"] < whole_bytes
        for k in ("mask_tpr", "mask_fpr", "acc"):
            np.testing.assert_array_equal(r[k], base[k], err_msg=k)
        ca, cb = r["c1c2"], base["c1c2"]
        np.testing.assert_array_equal(np.sign(ca), np.sign(cb))
        np.testing.assert_array_equal((np.abs(ca) > 0.5) & (np.abs(ca) < 2),
                                      (np.abs(cb) > 0.5) & (np.abs(cb) < 2))
        for k, g in r["params"].items():
            w = base["params"][k]
            assert g.shape == w.shape, k
            tol = 1e-5 * w.abs().max() + 1e-6
            assert (g - w).abs().max() <= tol, k
            assert torch.equal(g, ranks[0]["params"][k]), k
        # the round's collectives over the model group (size 2)
        model_gathers = [shape for kind, shape, n in r["round_recs"]
                         if kind == "all-gather" and n == 2]
        assert all(math.prod(s) < r["L"] for s in model_gathers)
        assert model_gathers.count((r["whole_cols"],)) == CFG["rounds"]
        assert 0 < r["whole_cols"] < r["L"]
        assert r["round_counts"]["all_reduce"] > 0
        # the whole params come back from one gather a tiled leaf, at
        # the run's end
        ts = r["tile_shapes"]
        assert ts and r["run_gathers"][-len(ts):] == ts
        np.testing.assert_allclose(r["l2_loss"], base["l2_loss"], rtol=1e-6)


VARIANTS = {"gaussian": dict(attack="gaussian", aggregator="diversefl"),
            "fltrust": dict(attack="sign_flip", aggregator="fltrust")}


def _variant(name, mesh):
    """zoo-tiny on ``mesh`` under a gaussian attack (its noise drawn at D
    and cut to the rank's tiles) or FLTrust (its root update built from
    the tiles): -> (whole params, masks' rates, acc)."""
    v = VARIANTS[name]
    model = zoo_model(ModelConfig(**TINY), seq_len=SEQ)
    cfg = FLConfig(**{**CFG, "aggregator": v["aggregator"], "rounds": 2},
                   attack=AttackConfig(kind=v["attack"]))
    fed = make_zoo_federation(model, cfg, torch.Generator().manual_seed(3),
                              per_client=PER, n_test=32, device="cpu")
    p0 = model.init(torch.Generator().manual_seed(1), "cpu")
    eng = RoundEngine(model, fed, cfg, mesh=mesh, batch_mode="inline")
    p, _, met, _ = eng.run_training(
        p0, torch.Generator().manual_seed(0), torch.full((cfg.rounds,), LR))
    host = sim.host_sync(met)
    return p, {k: np.asarray(host[k]) for k in host}


def _variant_rank(rank, world):
    mesh = make_host_mesh(1, 2, device="cpu")
    return {name: _variant(name, mesh) for name in VARIANTS}


def test_gaussian_noise_and_the_fltrust_root_on_tiles(tmp_path):
    """1 x 2: the gaussian rows cut from the whole (C, D) draw and the
    root's row built from the tiles give the meshless run's masks, and
    params within 1e-5·max|x| + 1e-6."""
    ranks = spawn_local(_variant_rank, 2, (), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    for name in VARIANTS:
        want_p, want_m = _variant(name, None)
        for r in ranks:
            p, m = r[name]
            assert set(m) == set(want_m), name
            for k in want_m:
                if k == "c1c2":
                    np.testing.assert_array_equal(np.sign(m[k]),
                                                  np.sign(want_m[k]))
                elif k != "_tel":
                    np.testing.assert_array_equal(m[k], want_m[k],
                                                  err_msg=(name, k))
            for k, w in want_p.items():
                tol = 1e-5 * w.abs().max() + 1e-6
                assert (p[k] - w).abs().max() <= tol, (name, k)
