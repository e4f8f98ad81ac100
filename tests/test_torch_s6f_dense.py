"""The dense round split over gloo data ranks (``sharding.client_split``):
each rank builds and computes only its rows of the round's clients, and
the statistics, the update rows and the new residual rows are gathered in
client order, so the round is the one-process round bit for bit.

softmax regression, 16 clients of 24 numpy-made samples (D = 36), f = 4,
3 rounds; ranks through ``launch.mesh.spawn_local`` (a ``FileStore`` under
``tmp_path``, one torch thread a rank, a time limit on the join), one
spawn of 2 ranks and one of 4 for the whole file.

Held:
* on 2 x 1 and 4 x 1 data meshes, every case of ``CASES`` (the rules
  diversefl, oracle, mean, median, krum and fltrust; the attacks
  sign_flip, gaussian and label_flip; the f32 and int8 codecs; the inline
  and segment batch modes; a participating subset that the ranks tile) is
  the port's meshless run bitwise: params, residual plane, every log;
* a rank's local SGD and guides see only its C/R rows, the guide matrix
  is never an ``all_gather``'s input, and each round gathers the update
  rows, the (C/R, 3) statistics under diversefl and the residual rows
  under int8, nothing else;
* rounds that do not split (23 clients on 2 ranks; a participating
  subset of 9 of 16) run whole on every rank, bitwise, with 0
  collectives;
* a whole run through ``run_federated_training`` on the mesh makes one
  ``host_sync`` and gives the meshless history;
* diversefl under sign_flip on the 4 x 1 mesh agrees with the
  reference's 4 x 1 dense run (a JAX subprocess on 8 forced host
  devices, its sealed samples and minibatch draws injected into the
  port): params within 1e-5·max|x| + 1e-6 a leaf, every round's mask
  equal.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData, partition_sorted_shards
from repro_torch.fl import (Federation, FLConfig, RoundEngine,
                            run_federated_training, softmax_regression)
from repro_torch.fl import simulator as sim
from repro_torch.launch.mesh import make_host_mesh, spawn_local

N, DIM, K, PER, F = 16, 8, 4, 24, 4
ROUNDS, LR = 3, 0.05
REF_ROUNDS = 5
RANK_TIMEOUT = 150

# (aggregator, attack, codec, batch mode, client_chunk, participation)
CASES = [
    ("diversefl", "sign_flip", "f32", "segment", None, 1.0),
    ("diversefl", "gaussian", "f32", "inline", 2, 1.0),
    ("diversefl", "label_flip", "int8", "segment", 2, 1.0),
    ("diversefl", "sign_flip", "f32", "inline", None, 0.5),
    ("oracle", "sign_flip", "int8", "inline", None, 1.0),
    ("mean", "gaussian", "int8", "inline", None, 1.0),
    ("median", "label_flip", "f32", "segment", None, 1.0),
    ("krum", "sign_flip", "f32", "segment", 2, 1.0),
    ("fltrust", "gaussian", "f32", "inline", 2, 1.0),
]
# rounds that run whole on every rank: (clients, participation)
WHOLE = [(23, 1.0), (N, 0.55)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_data(n, seed):
    """Class-centred Gaussian data, the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(77).normal(size=(K, DIM)) * 2.0
    y = rng.integers(0, K, size=n)
    x = centers[y] + rng.normal(size=(n, DIM))
    return x.astype(np.float32), y.astype(np.int32)


def _federation(cfg, enclave_idx=None):
    x, y = numpy_data(cfg.n_clients * PER, 0)
    tx, ty = numpy_data(120, 9)
    data = FederatedData.from_partitions(partition_sorted_shards(
        torch.from_numpy(x), torch.from_numpy(y).long(), cfg.n_clients), K)
    model = softmax_regression(input_dim=DIM, n_classes=K)
    fed = Federation.create(model, data, torch.from_numpy(tx),
                            torch.from_numpy(ty).long(), cfg,
                            torch.Generator().manual_seed(3), device="cpu",
                            enclave_idx=enclave_idx)
    return model, fed


def _cfg(agg, attack, codec, chunk, part, n=N, rounds=ROUNDS):
    return FLConfig(n_clients=n, f=F, rounds=rounds, eval_every=rounds,
                    batch_size=2, sample_frac=0.2, aggregator=agg,
                    attack=AttackConfig(kind=attack), compression=codec,
                    client_chunk=chunk, participation=part)


class _Watch:
    """Counts what a rank builds and computes: the client rows of every
    segment stack, of every local-SGD ``chunked_rows`` and of every
    ``compute_guides``, and whether an ``all_gather`` ever takes a guide
    matrix's storage."""

    def __init__(self, fed):
        self.vmap_rows, self.guide_rows, self.guides = [], [], []
        self.stack_rows, self.guide_gathered = [], False
        self._vmap, self._gather = sim.chunked_rows, sharding.api.all_gather
        self._fed, self._guides_fn = fed, fed.server.compute_guides
        self._stacks = fed.data.segment_minibatches

    def __enter__(self):
        def stacks(*a, **kw):
            out = self._stacks(*a, **kw)
            self.stack_rows.append(int(out[1].shape[1]))
            return out

        def vmap(fn, args, chunk=None):
            self.vmap_rows.append(int(args[0].shape[0]))
            return self._vmap(fn, args, chunk)

        def guides(*a, **kw):
            G = self._guides_fn(*a, **kw)
            self.guide_rows.append(int(G.shape[0]))
            self.guides.append(G)
            return G

        def gather(x, group):
            ptr = x.untyped_storage().data_ptr()
            if any(ptr == g.untyped_storage().data_ptr()
                   for g in self.guides):
                self.guide_gathered = True
            return self._gather(x, group)
        sim.chunked_rows, sharding.api.all_gather = vmap, gather
        self._fed.server.compute_guides = guides
        self._fed.data.segment_minibatches = stacks
        return self

    def __exit__(self, *exc):
        sim.chunked_rows, sharding.api.all_gather = self._vmap, self._gather
        self._fed.server.compute_guides = self._guides_fn
        self._fed.data.segment_minibatches = self._stacks
        self.guides = []


def _case(case, mesh, n=N):
    """One 3-round segment of ``case`` on ``mesh`` (None: one process)."""
    agg, attack, codec, mode, chunk, part = case
    cfg = _cfg(agg, attack, codec, chunk, part, n=n)
    model, fed = _federation(cfg)
    eng = RoundEngine(model, fed, cfg, mesh=mesh, batch_mode=mode)
    p0 = model.init(torch.Generator().manual_seed(1), "cpu")
    with sharding.record_collectives() as recs, _Watch(fed) as w:
        with sharding.use_mesh(mesh):
            rows = eng._body.client_rows()
        carry, logs = eng.run_segment(p0, torch.Generator().manual_seed(0),
                                      torch.full((ROUNDS,), LR))
    params, resid = carry if isinstance(carry, tuple) else (carry, None)
    return {"params": params, "resid": resid, "logs": logs, "rows": rows,
            "records": [(r["kind"], r["shape"]) for r in recs],
            "vmap_rows": w.vmap_rows, "guide_rows": w.guide_rows,
            "stack_rows": w.stack_rows, "guide_gathered": w.guide_gathered}


def _history(mesh):
    """A whole run through ``run_federated_training``: (history, syncs)."""
    cfg = _cfg("diversefl", "sign_flip", "f32", None, 1.0)
    model, fed = _federation(cfg)
    syncs = {"n": 0}
    real = sim.host_sync

    def counted(tree):
        syncs["n"] += 1
        return real(tree)
    sim.host_sync = counted
    try:
        h = run_federated_training(model, fed, cfg, lambda r: LR,
                                   engine=RoundEngine(model, fed, cfg,
                                                      mesh=mesh))
    finally:
        sim.host_sync = real
    return h, syncs["n"]


def _reference_run(mesh, ref_in):
    """diversefl under sign_flip, round by round, on the reference's
    sealed samples and minibatch draws: (params, per-round masks)."""
    cfg = _cfg("diversefl", "sign_flip", "f32", None, 1.0,
                rounds=REF_ROUNDS)
    model, fed = _federation(cfg, torch.from_numpy(ref_in["sidx"]).long())
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    p, gen, masks = model.init(None, "cpu"), torch.Generator(), []
    idx = torch.from_numpy(ref_in["batch_idx"]).long()
    for r in range(REF_ROUNDS):
        p, logs = eng.run_segment(p, gen, torch.full((1,), LR),
                                  draws={"batch_idx": idx[r:r + 1]})
        masks.append(logs["mask"])
    return {"params": p, "masks": torch.stack(masks),
            "mode": eng.batch_mode}


def _ranks(rank, world, ref_in):
    mesh = make_host_mesh(world, 1, device="cpu")
    out = {"cases": [_case(c, mesh) for c in CASES]}
    out["whole"] = []
    for n, part in WHOLE:
        before = sum(sharding.collective_counts().values())
        run = _case(("diversefl", "sign_flip", "int8", "inline", None,
                     part), mesh, n=n)
        run["collectives"] = sum(sharding.collective_counts().values()) \
            - before
        out["whole"].append(run)
    out["history"] = _history(mesh)
    if world == 4:
        out["reference"] = _reference_run(mesh, ref_in)
    return out


REF_DENSE = """
import jax.numpy as jnp
from repro.core.attacks import AttackConfig
from repro.data import FederatedData
from repro.fl import Federation, FLConfig, RoundEngine
from repro.fl.small_models import softmax_regression
from repro.launch.mesh import make_host_mesh

cfg = FLConfig(n_clients=16, f=4, rounds=5, eval_every=5, batch_size=2,
               sample_frac=0.2, aggregator="diversefl",
               attack=AttackConfig(kind="sign_flip"), seed=0)
data = FederatedData(jnp.asarray(IN["x"]), jnp.asarray(IN["y"]), 4)
model = softmax_regression(input_dim=8, n_classes=4)
fed = Federation.create(model, data, jnp.asarray(IN["tx"]),
                        jnp.asarray(IN["ty"]), cfg, jax.random.PRNGKey(2))
for j in range(cfg.n_clients):
    fed.server.ingest_samples(j, jnp.asarray(IN["gx"][j]),
                              jnp.asarray(IN["gy"][j]))
eng = RoundEngine(model, fed, cfg, mesh=make_host_mesh(data=4, model=1))
p, key = model.init(jax.random.PRNGKey(1)), jax.random.PRNGKey(0)
for r in range(cfg.rounds):
    p, key, logs = eng.run_segment(p, key, jnp.full((1,), 0.05, jnp.float32))
    OUT[f"mask_{r}"] = np.asarray(logs["mask"])
for k, v in p.items():
    OUT[f"p_{k}"] = np.asarray(v)
"""


def _reference_inputs():
    """The federation's arrays, a fixed enclave sample, and the
    reference's minibatch draws rebuilt from its key chain (``key, sub =
    split(key)``; ``kb = split(sub, 4)[0]``; one key a client)."""
    import jax
    cfg = _cfg("diversefl", "sign_flip", "f32", None, 1.0,
               rounds=REF_ROUNDS)
    _, fed = _federation(cfg)
    d = fed.data
    s = d.sample_size(cfg.sample_frac)
    sidx = np.stack([np.random.default_rng(40 + j).permutation(PER)[:s]
                     for j in range(N)])
    gx, gy = d.minibatch(s, idx=torch.from_numpy(sidx))
    key, idx = jax.random.PRNGKey(cfg.seed), []
    for _ in range(REF_ROUNDS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(jax.random.split(sub, 4)[0], N)
        idx.append(np.stack([np.asarray(jax.random.randint(
            k, (cfg.batch_size,), 0, d.per_client)) for k in keys]))
    return {"x": d.x.numpy(), "y": d.y.numpy().astype(np.int32),
            "tx": fed.test_x.numpy(),
            "ty": fed.test_y.numpy().astype(np.int32),
            "gx": gx.numpy(), "gy": gy.numpy().astype(np.int32),
            "sidx": sidx, "batch_idx": np.stack(idx)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results on 2 and 4 ranks, the one-process runs, and
    the reference's 4 x 1 run (its subprocess beside the ranks)."""
    from test_torch_s6b_layout import run_reference
    ref_in = _reference_inputs()
    ref = {}
    # both directories first: pytest makes its base directory on the
    # first call, which two threads must not race to
    ref_dir, tmp = (tmp_path_factory.mktemp(n) for n in ("ref", "ranks"))
    def reference():
        try:
            ref.update(run_reference(REF_DENSE, ref_dir, ref_in, devices=8))
        except BaseException as exc:         # re-raised after the join
            ref["error"] = exc
    t = threading.Thread(target=reference)
    t.start()
    try:
        out = {R: spawn_local(_ranks, R, (ref_in,), timeout=RANK_TIMEOUT,
                              workdir=tmp) for R in (2, 4)}
    finally:
        t.join()
    if "error" in ref:
        raise ref["error"]
    out["one"] = {"cases": [_case(c, None) for c in CASES],
                  "whole": [_case(("diversefl", "sign_flip", "int8",
                                   "inline", None, part), None, n=n)
                            for n, part in WHOLE],
                  "history": _history(None),
                  "reference": _reference_run(None, ref_in)}
    out["ref"] = ref
    return out


def _bitwise(got, want):
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    if want["resid"] is None:
        assert got["resid"] is None
    else:
        assert torch.equal(got["resid"], want["resid"])
    assert set(got["logs"]) == set(want["logs"])
    for k in want["logs"]:
        assert torch.equal(got["logs"][k], want["logs"][k]), k


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=["-".join(map(str, c)) for c in CASES])
def test_split_round_is_the_one_process_round(runs, R, i):
    want = runs["one"]["cases"][i]
    agg, _, codec, mode, chunk, part = CASES[i]
    C = int(N * part)
    for r, got in enumerate(x["cases"][i] for x in runs[R]):
        _bitwise(got, want)
        assert got["rows"] == (r * C // R, (r + 1) * C // R)
        # local work: the rank's C/R rows only, its stacks too (one
        # segment of all the rounds)
        assert got["stack_rows"] == ([C // R] if mode == "segment" else [])
        assert got["vmap_rows"] == [C // R] * ROUNDS
        assert got["guide_rows"] == ([C // R] * ROUNDS
                                     if agg == "diversefl" else [])
        assert not got["guide_gathered"]
        # a round's collectives: the update rows, the statistics under
        # diversefl, the residual rows under int8 (int8 decodes to f32)
        rows = [("all-gather", (C // R, 36))]
        if agg == "diversefl":
            rows.append(("all-gather", (C // R, 3)))
        if codec == "int8":
            rows.append(("all-gather", (C // R, 36)))
        assert sorted(got["records"]) == sorted(rows * ROUNDS)
    assert want["records"] == [] and want["rows"] is None
    assert want["stack_rows"] == ([C] if mode == "segment" else [])


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("j", range(len(WHOLE)),
                         ids=[f"n{n}-p{p}" for n, p in WHOLE])
def test_round_that_does_not_tile_runs_whole(runs, R, j):
    want = runs["one"]["whole"][j]
    n, part = WHOLE[j]
    C = _cfg("diversefl", "sign_flip", "int8", None, part, n=n).n_selected
    for got in (x["whole"][j] for x in runs[R]):
        _bitwise(got, want)
        assert got["rows"] is None and got["collectives"] == 0
        assert got["records"] == []
        assert got["vmap_rows"] == [C] * ROUNDS
        assert got["guide_rows"] == [C] * ROUNDS


@pytest.mark.parametrize("R", [2, 4])
def test_one_host_sync_and_the_meshless_history(runs, R):
    want, syncs = runs["one"]["history"]
    assert syncs == 1
    for h, n in (x["history"] for x in runs[R]):
        assert n == 1
        for k in ("round", "acc", "mask_tpr", "mask_fpr"):
            assert h[k] == want[k], k
        assert all(np.array_equal(a, b) for a, b in zip(h["c1c2"],
                                                        want["c1c2"]))
        for k in want["params"]:
            assert torch.equal(h["params"][k], want["params"][k]), k


def test_split_round_agrees_with_the_references_4x1_run(runs):
    ref, one = runs["ref"], runs["one"]["reference"]
    for got in (x["reference"] for x in runs[4]):
        assert got["mode"] == "segment"
        assert torch.equal(got["masks"], one["masks"])
        for k, v in got["params"].items():
            assert torch.equal(v, one["params"][k]), k
            w = ref[f"p_{k}"]
            tol = 1e-5 * np.abs(w).max() + 1e-6
            assert np.abs(v.numpy() - w).max() <= tol, k
        for r in range(REF_ROUNDS):
            np.testing.assert_array_equal(got["masks"][r].numpy(),
                                          ref[f"mask_{r}"], f"round {r}")
