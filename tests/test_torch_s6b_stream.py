"""The streaming fold, the engine and the sweep over gloo data ranks,
against the same work in one process (``launch.mesh.spawn_local``: a
``FileStore`` under ``tmp_path``, one torch thread a rank, a time limit on
the join).

* S data ranks (auto shard count from the mesh) fold bitwise the
  one-process ``stream_shards=S`` fold, params and per-client logs, for
  every streaming rule and under gaussian noise (the twin of
  ``tests/test_stream_shards.py::test_mesh_sharded_fold_bitwise_subprocess``).
* A (2, 2, 1) pod mesh (pods and shards auto) folds bitwise the
  one-process ``pods=2, stream_shards=2`` fold (the twin of
  ``tests/test_tree_agg.py::test_pod_mesh_fold_and_pipeline_bitwise_subprocess``),
  and ``put_clients_by_shard`` builds each rank's contiguous block of the
  client axis, pod-major.
* ``make_host_pod_mesh`` refuses a world too small by name, and
  ``make_host_mesh`` with no card and no ``device="cpu"`` raises.
* The zoo on a data mesh (4 x 1, and a 1 x 1 mesh) is its meshless run,
  bitwise, with one ``host_sync`` and (at 1 x 1) no collective.
* ``sweep_put`` over 2 data ranks: the sweep's cells equal the meshless
  sweep's, bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import (FederatedData, make_classification,
                              partition_sorted_shards)
from repro_torch.fl import (Federation, FLConfig, RoundEngine, SweepSpec,
                            make_zoo_federation, run_federated_sweep,
                            run_federated_training, softmax_regression,
                            zoo_model)
from repro_torch.fl import simulator as sim
from repro_torch.launch.mesh import (make_host_mesh, make_host_pod_mesh,
                                     spawn_local)
from repro_torch.models import ModelConfig
from repro_torch.optim import inv_sqrt_lr

N, DIM, NC = 64, 8, 4
RULES = ("diversefl", "oracle", "mean", "fltrust")
RANK_TIMEOUT = 120


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fed(cfg, n=N):
    x, y = make_classification(torch.Generator().manual_seed(0), n * 8, NC,
                               DIM)
    data = FederatedData.from_partitions(partition_sorted_shards(x, y, n),
                                         NC)
    tx, ty = make_classification(torch.Generator().manual_seed(9), 64, NC,
                                 DIM)
    model = softmax_regression(input_dim=DIM, n_classes=NC)
    return model, Federation.create(model, data, tx, ty, cfg,
                                    torch.Generator().manual_seed(2),
                                    device="cpu")


def _segment(agg, mesh=None, attack="sign_flip", **kw):
    """Two rounds of one segment; (flat params, logs).  Gaussian noise is
    a draw beyond the minibatches, so its rounds draw inline."""
    cfg = FLConfig(n_clients=N, f=12, rounds=2, batch_size=2, eval_every=2,
                   l2=0.0, client_chunk=8, streaming=True, aggregator=agg,
                   attack=AttackConfig(kind=attack), **kw)
    model, fed = _fed(cfg)
    eng = RoundEngine(model, fed, cfg, mesh=mesh, batch_mode="segment"
                      if attack != "gaussian" else "inline")
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    lrs = torch.tensor([float(inv_sqrt_lr(0.05)(r)) for r in (1, 2)])
    p, logs = eng.run_segment(params, torch.Generator().manual_seed(0), lrs)
    return torch.cat([v.reshape(-1) for v in p.values()]), logs


def _fold_ranks(rank, world, pods):
    """Every rule on this rank's mesh: data ranks = world (pods = None) or
    a (pods, world / pods, 1) pod mesh."""
    if not torch.cuda.is_available():
        # the card unless the caller asks for the CPU: no silent fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh(world, 1)
    if pods is None:
        mesh = make_host_mesh(world, 1, device="cpu")
    else:
        mesh = make_host_pod_mesh(pods, world // pods, 1, device="cpu")
        with pytest.raises(ValueError, match="needs 16 ranks but only 4"):
            make_host_pod_mesh(4, 4, 1, device="cpu")
    before = sharding.collective_counts()
    out = {agg: _segment(agg, mesh=mesh) for agg in RULES}
    # a rank folds only its blocks: the other blocks' noise is drawn and
    # dropped, so the generator stays in step
    out["gaussian"] = _segment("diversefl", mesh=mesh, attack="gaussian")
    after = sharding.collective_counts()
    with sharding.use_mesh(mesh):
        block = sharding.put_clients_by_shard(
            lambda lo, hi: torch.arange(lo, hi), (N,))
        counts = (sharding.data_shard_count(), sharding.pod_data_counts())
    return {"runs": out, "block": block, "counts": counts,
            "gathers": after["all_gather"] - before["all_gather"]}


def _same(got, want):
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("S", [2, 4])
def test_data_ranks_fold_the_one_process_sharded_fold(S, tmp_path):
    ranks = spawn_local(_fold_ranks, S, (None,), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    for agg in RULES:
        want = _segment(agg, stream_shards=S)
        for r in ranks:
            _same(r["runs"][agg], want)
    want = _segment("diversefl", attack="gaussian", stream_shards=S)
    for r in ranks:
        _same(r["runs"]["gaussian"], want)
    for c, r in enumerate(ranks):
        assert r["counts"] == (S, (1, S)) and r["gathers"] > 0
        assert torch.equal(r["block"], torch.arange(c * N // S,
                                                    (c + 1) * N // S))


def test_pod_mesh_folds_the_one_process_two_tier_fold(tmp_path):
    ranks = spawn_local(_fold_ranks, 4, (2,), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    for agg in RULES:
        want = _segment(agg, pods=2, stream_shards=2)
        for r in ranks:
            _same(r["runs"][agg], want)
    want = _segment("diversefl", attack="gaussian", pods=2, stream_shards=2)
    for r in ranks:
        _same(r["runs"]["gaussian"], want)
    for c, r in enumerate(ranks):            # pod-major contiguous blocks
        assert r["counts"] == (4, (2, 2))
        assert torch.equal(r["block"], torch.arange(c * 16, (c + 1) * 16))


# ----------------------------------------------------------------------
# the zoo on a data mesh, and the sweep
# ----------------------------------------------------------------------

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)


def _zoo_run(rank, world, mesh_shape):
    model = zoo_model(ModelConfig(**TINY), seq_len=8)
    cfg = FLConfig(n_clients=4, f=1, rounds=4, batch_size=4, l2=0.0,
                   streaming=True, stream_shards=1, eval_every=2,
                   attack=AttackConfig(kind="sign_flip"))
    fed = make_zoo_federation(model, cfg, torch.Generator().manual_seed(3),
                              per_client=16, n_test=32, device="cpu")
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          device="cpu")
    syncs = {"n": 0}
    real = sim.host_sync

    def counted(tree):
        syncs["n"] += 1
        return real(tree)
    sim.host_sync = counted
    before = sum(sharding.collective_counts().values())
    h = run_federated_training(model, fed, cfg, lambda r: 0.05,
                               engine=RoundEngine(model, fed, cfg, mesh=mesh))
    sim.host_sync = real
    return {"h": h, "syncs": syncs["n"],
            "collectives": sum(sharding.collective_counts().values())
            - before}


def test_zoo_on_a_data_mesh_is_the_meshless_run(tmp_path):
    """bf16 zoo-tiny: 4 x 1 and 1 x 1 meshes give the meshless history and
    params bit for bit, one host sync each, no collective."""
    base = _zoo_run(0, 1, None)
    runs = spawn_local(_zoo_run, 4, ((4, 1),), timeout=RANK_TIMEOUT,
                       workdir=tmp_path) + \
        spawn_local(_zoo_run, 1, ((1, 1),), timeout=RANK_TIMEOUT,
                    workdir=tmp_path)
    b = base["h"]
    for r in runs:
        h = r["h"]
        assert r["syncs"] == 1 and r["collectives"] == 0
        for k in ("round", "acc", "mask_tpr", "mask_fpr"):
            assert h[k] == b[k], k
        assert all(np.array_equal(x, y) for x, y in zip(h["c1c2"],
                                                        b["c1c2"]))
        for k in b["params"]:
            assert torch.equal(h["params"][k], b["params"][k]), k


def _sweep(rank, world, use):
    base = FLConfig(n_clients=8, f=2, rounds=4, batch_size=2, eval_every=2,
                    l2=0.0, attack=AttackConfig(kind="sign_flip"))
    spec = SweepSpec(base=base, seeds=(0, 1, 2, 3),
                     aggregators=("diversefl", "mean"))
    model, fed = _fed(base, n=8)
    mesh = make_host_mesh(world, 1, device="cpu") if use else None
    before = sharding.collective_counts()["all_gather"]
    with sharding.use_mesh(mesh):
        hists = run_federated_sweep(model, fed, spec, inv_sqrt_lr(0.05))
    return {"hists": hists,
            "gathers": sharding.collective_counts()["all_gather"] - before}


def test_sweep_put_over_data_ranks_is_the_meshless_sweep(tmp_path):
    want = _sweep(0, 1, False)["hists"]
    ranks = spawn_local(_sweep, 2, (True,), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    for r in ranks:
        assert r["gathers"] > 0 and len(r["hists"]) == len(want) == 8
        for got, w in zip(r["hists"], want):
            for k in ("round", "acc", "mask_tpr", "mask_fpr"):
                assert got[k] == w[k], k
            assert all(np.array_equal(x, y) for x, y in zip(got["c1c2"],
                                                            w["c1c2"]))
            for k in w["params"]:
                assert torch.equal(got["params"][k], w["params"][k]), k
