"""The round engine on a client x model mesh over gloo ranks: the twin of
``tests/test_model_fl.py::test_model_mesh_engine_subprocess`` at its
zoo-tiny config (2 layers, d 32, vocab 64, seq 8; 4 clients, f = 1 under
sign_flip, 4 rounds, streaming diversefl with ``stream_shards=1``, eval
every 2).

The reference runs in a subprocess on 8 forced host devices, meshless and
on its 4 x 2 mesh, in fp32; it hands its data, sealed samples, initial
params, minibatch draws (rebuilt from its key chain) and results over as
``.npz``.  The port runs on the same inputs in one process and in 8 gloo
ranks (``launch.mesh.spawn_local``, a ``FileStore`` under ``tmp_path``,
one torch thread a rank, a time limit on the join).  The data-mesh half
of the twin (4 x 1 bitwise the meshless run) is in
``test_torch_s6b_stream.py``.

Held:
* a 4 x 2 mesh agrees with the port's meshless run and with the
  reference's 4 x 2 run: params within 1e-5·max|x| + 1e-6 of each leaf,
  the same masks (detection rates, C1 signs and C2 pass/fail), accuracy
  equal;
* the blocked layout round-trips bit for bit under the live 4 x 2 mesh,
  a rank's rows are the blocked matrix's, and the fold's monoid laws hold
  on the rank's row;
* every streaming rule (diversefl, oracle, mean, fltrust) on the 4 x 2
  mesh, 64 softmax-regression clients whose leaves do not tile the model
  axis: params within the tolerance above of the one-process
  ``stream_shards=4`` fold, masks equal;
* every run makes exactly one ``host_sync``.
"""
import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData
from repro_torch.fl import (Federation, FLConfig, RoundEngine,
                            weighted_mean_rule, zoo_model)
from repro_torch.fl import simulator as sim
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.models import ModelConfig

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)
CFG = dict(n_clients=4, f=1, rounds=4, local_steps=1, batch_size=4, l2=0.0,
           aggregator="diversefl", streaming=True, stream_shards=1,
           eval_every=2, seed=0, compression="f32")
SEQ, PER, N_TEST, LR = 8, 16, 32, 0.05
RANK_TIMEOUT = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_ENGINE = """
import jax.numpy as jnp
from repro.core.attacks import AttackConfig
from repro.fl import FLConfig, RoundEngine, make_zoo_federation, zoo_model
from repro.launch.mesh import make_host_mesh
from repro.models.config import ModelConfig

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)
model = zoo_model(ModelConfig(**TINY, dtype="float32",
                              param_dtype="float32"), seq_len=8)
cfg = FLConfig(n_clients=4, f=1, rounds=4, local_steps=1, batch_size=4,
               l2=0.0, aggregator="diversefl", streaming=True,
               stream_shards=1, eval_every=2, seed=0, compression="f32",
               attack=AttackConfig(kind="sign_flip"))
fed = make_zoo_federation(model, cfg, per_client=16, n_test=32)
p0 = model.init(jax.random.PRNGKey(cfg.seed + 1))
lrs = jnp.full((cfg.rounds,), 0.05, jnp.float32)
d = fed.data
OUT.update(x=np.asarray(d.x), y=np.asarray(d.y),
           n_classes=np.asarray(d.n_classes), test_x=np.asarray(fed.test_x),
           test_y=np.asarray(fed.test_y))
for j in range(cfg.n_clients):
    sx, sy = fed.server.enclave.unseal_samples(j)
    OUT[f"sx_{j}"], OUT[f"sy_{j}"] = np.asarray(sx), np.asarray(sy)
for i, leaf in enumerate(jax.tree.leaves(p0)):
    OUT[f"p0_{i:03d}"] = np.asarray(leaf)
key, idx = jax.random.PRNGKey(cfg.seed), []
for _ in range(cfg.rounds):
    key, sub = jax.random.split(key)
    kb = jax.random.split(sub, 4)[0]
    idx.append(np.stack([np.asarray(jax.random.randint(
        k, (cfg.batch_size,), 0, d.per_client))
        for k in jax.random.split(kb, cfg.n_clients)]))
OUT["batch_idx"] = np.stack(idx)
for name, mesh in (("none", None), ("4x2", make_host_mesh(data=4, model=2))):
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    p, _, met, rounds = eng.run_training(p0, jax.random.PRNGKey(cfg.seed),
                                         lrs)
    for i, leaf in enumerate(jax.tree.leaves(p)):
        OUT[f"{name}_p_{i:03d}"] = np.asarray(leaf)
    for k in ("acc", "c1c2", "mask_tpr", "mask_fpr"):
        OUT[f"{name}_{k}"] = np.asarray(met[k])
    OUT[f"{name}_ms"] = np.asarray(eng.model_shards)
"""


def _port_run(rank, world, ref, dtype, mesh_shape):
    """One port engine run on the reference's inputs; on the 4 x 2 mesh
    also the blocked-layout checks under the live mesh."""
    kw = dict(TINY, dtype=dtype, param_dtype=dtype)
    model = zoo_model(ModelConfig(**kw), seq_len=SEQ)
    cfg = FLConfig(**CFG, attack=AttackConfig(kind="sign_flip"))
    data = FederatedData(torch.from_numpy(ref["x"]).long(),
                         torch.from_numpy(ref["y"]).long(),
                         int(ref["n_classes"]))
    fed = Federation.create(model, data,
                            torch.from_numpy(ref["test_x"]).long(),
                            torch.from_numpy(ref["test_y"]).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    for j in range(cfg.n_clients):
        fed.server.ingest_samples(j, ref[f"sx_{j}"], ref[f"sy_{j}"])
    like = model.init(torch.Generator().manual_seed(0), "cpu")
    p0 = {k: torch.from_numpy(ref[f"p0_{i:03d}"]).to(like[k].dtype)
          for i, k in enumerate(like)}
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          device="cpu")
    syncs = {"n": 0}
    real = sim.host_sync

    def counted(tree):
        syncs["n"] += 1
        return real(tree)
    sim.host_sync = counted
    before = sharding.collective_counts()
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    p, _, met, rounds = eng.run_training(
        p0, torch.Generator().manual_seed(0),
        torch.full((cfg.rounds,), LR, dtype=torch.float32),
        draws={"batch_idx": torch.from_numpy(ref["batch_idx"]).long()})
    host = sim.host_sync(met)
    after = sharding.collective_counts()
    sim.host_sync = real
    out = {"params": p, "rounds": rounds, "syncs": syncs["n"],
           "ms": eng.model_shards,
           "collectives": sum(after.values()) - sum(before.values()),
           **{k: np.asarray(host[k]) for k in ("acc", "c1c2", "mask_tpr",
                                                "mask_fpr")}}
    if mesh_shape == (4, 2):
        out["layout"] = _layout_checks(mesh)
        # every streaming rule on the 4 x 2 mesh: 64 softmax-regression
        # clients in 8 blocks over the 4 data ranks, leaves that do not
        # tile the model axis (row-major pad-and-split)
        from test_torch_s6b_stream import RULES, _segment
        out["rules"] = {agg: _segment(agg, mesh=mesh) for agg in RULES}
    return out


def _layout_checks(mesh):
    """The blocked layout under the live 4 x 2 mesh (integer values, so
    every sum is exact)."""
    upd = {"wq": torch.arange(2 * 2 * 4 * 8, dtype=torch.float32
                              ).reshape(2, 2, 4, 8),
           "norm_b": torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5)}
    with sharding.use_mesh(mesh):
        assert sharding.model_shard_count() == 2
        from repro_torch.fl.streaming import flat_ndim, stat_sum
        assert flat_ndim() == 2
        blk, unravel = sharding.flatten_updates_sharded(upd)
        assert blk.dim() == 3 and blk.shape[1] == 2
        out = unravel(blk[1])
        for k in upd:
            assert torch.equal(out[k], upd[k][1]), k
        s = sharding.model_index()
        row = sharding.shard_updates(blk)[:, 0]    # this rank's rows
        assert torch.equal(row, blk[:, s])
        # per-client stats: the row's sum + the model group's all_reduce
        # -> the sum over the whole blocked client
        assert torch.equal(stat_sum(row * row),
                           (blk * blk).sum((1, 2)))
        rule = weighted_mean_rule(
            lambda u, ci: (torch.ones(u.shape[:-1]),) * 2 + ({},))
        L = row.shape[1]
        sA, _ = rule.update(rule.init(L), row[0], {})
        sAB, _ = rule.update(sA, row[1], {})
        sB, _ = rule.update(rule.init(L), row[1], {})
        merged = rule.merge(sA, sB)
        assert all(torch.equal(x, y) for x, y in zip(sAB, merged))
        delta, _ = rule.finalize(sAB)
        assert torch.equal(delta, (row[0] + row[1]) / 2.0)
        full = sharding.all_gather(delta, sharding.model_group())
        assert torch.equal(full, (blk[0] + blk[1]) / 2.0)
        # diversefl's block statistics: the similarity op on the rank's
        # rows, then one all_reduce of the (chunk, 3) stats (and one for
        # the non-finite guard) -> the whole clients' masks and stats;
        # client 0's guide is its update (kept), client 1's its negation
        from repro_torch.fl.server import AggregationContext
        from repro_torch.fl.streaming import get_streaming
        dfl = get_streaming("diversefl").bind(AggregationContext())
        sign = torch.tensor([[1.0], [-1.0]])
        n0 = sharding.collective_counts()["all_reduce"]
        _, _, got = dfl.weights(row, {"guide": row * sign})
        assert sharding.collective_counts()["all_reduce"] - n0 == 2
        whole = blk.reshape(2, -1)
        with sharding.use_mesh(None):
            _, _, want = dfl.weights(whole, {"guide": whole * sign})
        assert got["mask"].tolist() == [True, False]
        for k in want:
            assert torch.equal(got[k], want[k]), k
    return True


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and results (one subprocess per file)."""
    from test_torch_s6b_layout import run_reference
    return run_reference(REF_ENGINE, tmp_path_factory.mktemp("ref"), {},
                         devices=8)


def _close(got, want_leaves, what):
    for (k, g), w in zip(got.items(), want_leaves):
        g = g.float().numpy()
        tol = 1e-5 * np.abs(w).max() + 1e-6
        assert np.abs(g - w).max() <= tol, (what, k, np.abs(g - w).max())


def _same_masks(a, b):
    for k in ("mask_tpr", "mask_fpr", "acc"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ca, cb = np.asarray(a["c1c2"]), np.asarray(b["c1c2"])
    np.testing.assert_array_equal(np.sign(ca), np.sign(cb))
    passes = [(np.abs(c) > 0.5) & (np.abs(c) < 2.0) for c in (ca, cb)]
    np.testing.assert_array_equal(*passes)


def test_model_mesh_agrees_with_meshless_and_the_references(ref, tmp_path):
    """fp32: the 4 x 2 mesh against the port's meshless run and the
    reference's 4 x 2 (and meshless) runs."""
    assert int(ref["4x2_ms"]) == 2
    base = _port_run(0, 1, ref, "float32", None)
    runs = spawn_local(_port_run, 8, (ref, "float32", (4, 2)),
                       timeout=RANK_TIMEOUT, workdir=tmp_path)
    n = len(base["params"])
    ref_none = [ref[f"none_p_{i:03d}"] for i in range(n)]
    ref_mesh = [ref[f"4x2_p_{i:03d}"] for i in range(n)]
    for r in runs:
        assert r["syncs"] == 1 and r["ms"] == 2 and r["layout"]
        assert r["collectives"] > 0
        _same_masks(r, base)
        _same_masks(r, {k: ref[f"4x2_{k}"] for k in
                        ("acc", "c1c2", "mask_tpr", "mask_fpr")})
        _close(r["params"], [v.float().numpy()
                             for v in base["params"].values()], "meshless")
        _close(r["params"], ref_mesh, "reference 4x2")
        for k in r["params"]:
            assert torch.equal(r["params"][k], runs[0]["params"][k]), k
    _close(base["params"], ref_none, "reference meshless")
    from test_torch_s6b_stream import RULES, _segment
    for agg in RULES:
        flat, logs = _segment(agg, stream_shards=4)
        for r in runs:
            got_flat, got_logs = r["rules"][agg]
            tol = 1e-5 * flat.abs().max().item() + 1e-6
            assert (got_flat - flat).abs().max().item() <= tol, agg
            if "mask" in logs:
                assert torch.equal(got_logs["mask"], logs["mask"]), agg
