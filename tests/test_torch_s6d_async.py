"""Async rounds on a model axis > 1: the staleness slab on the blocked
rows, over gloo ranks, against the reference's 4 x 2 mesh and the port's
meshless run.

The reference runs in one subprocess (``run_reference`` of
``test_torch_s6b_layout.py``) on 8 forced host devices: zoo-tiny in fp32
(2 layers, d 32, vocab 64, seq 8; 4 clients, f = 1 under sign_flip,
streaming with ``stream_shards=1``), 3 rounds on its 4 x 2 mesh, one
``run_segment`` a round, under four fault models: intermittent NaN
faults with a 0.75 cohort, dropout, and stragglers (delay 1) through a
2-slot slab under diversefl and under fltrust.  Stragglers without a slab
(each expires) are held against the port's meshless run only, on the
straggler run's inputs.  Its async carry is built under ``use_mesh(mesh)``: its
``RoundEngine._flat_shape`` reads the active mesh, not the engine's, so
a carry built outside it gets a one-shard slab that the landing fold
cannot broadcast (a hazard of the reference, ROADMAP.md).  The port
builds its carry outside any ``use_mesh`` and takes the layout from the
engine's own mesh.  The reference hands its data, sealed samples, root
set, initial params, draws (minibatch indices and fault rows from its key
chain, its cohort chain), per-round logs, params and slab over as
``.npz``; the port runs the same inputs in one process and in 8 gloo
ranks (``launch.mesh.spawn_local``).

Held, for each fault model:
* against the reference's 4 x 2 run and the port's meshless run: every
  round's keep mask, candidates, cohort size and stale counts (buffered,
  folded, expired) equal; params within 1e-5·max|x| + 1e-6 of each leaf;
  C1 signs, C2 pass/fail, TPR/FPR and accuracy equal;
* the slab: each rank holds a (B, L) row, its slot ids, TTLs and
  occupancy equal the reference's and the meshless run's, and its row
  is within the tolerance of the reference's (B, ms, L) slab's row s and
  of the meshless (B, D) slab's blocked row;
* a gaussian attack with the slab on 4 x 2, the noise drawn by the port's
  generator, against the port's meshless run: params within the
  tolerance, masks and stale counts equal, and the generator's next draw
  equal (the slab's (B, D) noise is drawn whole and cut).
"""
import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData
from repro_torch.fl import Federation, FLConfig, RoundEngine, zoo_model
from repro_torch.fl import simulator as sim
from repro_torch.fl.faults import FaultConfig
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.models import ModelConfig

TINY = dict(name="zoo-tiny", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)
BASE = dict(n_clients=4, f=1, rounds=3, local_steps=1, batch_size=4, l2=0.0,
            streaming=True, stream_shards=1, eval_every=3, seed=0)
STRAGGLER = dict(fault=FaultConfig("straggler", rate=0.5, delay=1),
                 staleness_buffer=2)
CONFIGS = {
    "intermittent": dict(aggregator="diversefl", cohort_participation=0.75,
                         fault=FaultConfig("intermittent", rate=0.3,
                                           mode="nan")),
    "dropout": dict(aggregator="diversefl",
                    fault=FaultConfig("dropout", rate=0.3)),
    "straggler, no slab": dict(aggregator="diversefl",
                               fault=FaultConfig("straggler", rate=0.5,
                                                 delay=1)),
    "straggler": dict(aggregator="diversefl", **STRAGGLER),
    "straggler fltrust": dict(aggregator="fltrust", **STRAGGLER),
}
# held against the port's meshless run only, on the straggler run's
# inputs and draws (the same seed and fault rate), to keep the file's one
# reference subprocess short
MESHLESS_ONLY = {"straggler, no slab": "straggler"}
LOG_KEYS = ("mask", "cand", "cohort", "stale_buffered", "stale_folded",
            "stale_expired", "sel", "byz")
SEQ, LR = 8, 0.05
RANK_TIMEOUT = 180


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_ASYNC = """
import jax.numpy as jnp
from repro.core.attacks import AttackConfig
from repro.fl import FLConfig, RoundEngine, make_zoo_federation, zoo_model
from repro.fl.engine import _COHORT_FOLD
from repro.fl.faults import FaultConfig, make_cohort_chain
from repro.launch.mesh import make_host_mesh
from repro.models.config import ModelConfig
from repro.sharding.api import use_mesh

model = zoo_model(ModelConfig(
    name="zoo-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab_size=64, attn_direct_max=16, dtype="float32",
    param_dtype="float32"), seq_len=8)
mesh = make_host_mesh(data=4, model=2)
BASE = dict(n_clients=4, f=1, rounds=3, local_steps=1, batch_size=4,
            l2=0.0, streaming=True, stream_shards=1, eval_every=3, seed=0,
            attack=AttackConfig(kind="sign_flip"))
STRAGGLER = dict(fault=FaultConfig("straggler", rate=0.5, delay=1),
                 staleness_buffer=2)
CONFIGS = {
    "intermittent": dict(aggregator="diversefl", cohort_participation=0.75,
                         fault=FaultConfig("intermittent", rate=0.3,
                                           mode="nan")),
    "dropout": dict(aggregator="diversefl",
                    fault=FaultConfig("dropout", rate=0.3)),
    "straggler": dict(aggregator="diversefl", **STRAGGLER),
    "straggler fltrust": dict(aggregator="fltrust", **STRAGGLER),
}
p0 = model.init(jax.random.PRNGKey(BASE["seed"] + 1))
for i, leaf in enumerate(jax.tree.leaves(p0)):
    OUT[f"p0_{i:03d}"] = np.asarray(leaf)
lrs = jnp.full((1,), 0.05, jnp.float32)
for name, kw in CONFIGS.items():
    cfg = FLConfig(**BASE, **kw)
    fed = make_zoo_federation(model, cfg, per_client=16, n_test=32)
    d, P = fed.data, name + "/"
    OUT.update({P + "x": np.asarray(d.x), P + "y": np.asarray(d.y),
                P + "n_classes": np.asarray(d.n_classes),
                P + "test_x": np.asarray(fed.test_x),
                P + "test_y": np.asarray(fed.test_y),
                P + "root_x": np.asarray(fed.root_x),
                P + "root_y": np.asarray(fed.root_y)})
    for j in range(cfg.n_clients):
        sx, sy = fed.server.enclave.unseal_samples(j)
        OUT[f"{P}sx_{j}"], OUT[f"{P}sy_{j}"] = np.asarray(sx), np.asarray(sy)
    key, idx, faults = jax.random.PRNGKey(cfg.seed), [], []
    for _ in range(cfg.rounds):
        key, sub = jax.random.split(key)
        kb, _, _, ks = jax.random.split(sub, 4)
        idx.append(np.stack([np.asarray(jax.random.randint(
            k, (cfg.batch_size,), 0, d.per_client))
            for k in jax.random.split(kb, cfg.n_clients)]))
        faults.append(np.asarray(jax.random.uniform(ks, (cfg.n_clients,))
                                 < jnp.float32(cfg.fault.rate)))
    OUT[P + "batch_idx"] = np.stack(idx)
    OUT[P + "fault_rows"] = np.stack(faults)
    if cfg.cohort_participation is not None:
        OUT[P + "cohort"] = np.array(make_cohort_chain(
            cfg.n_clients, cfg.rounds, cfg.cohort_participation,
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), _COHORT_FOLD)))
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    with use_mesh(mesh):
        carry = eng.init_carry(p0)
    key = jax.random.PRNGKey(cfg.seed)
    for r in range(cfg.rounds):
        carry, key, logs = eng.run_segment(carry, key, lrs)
        for k in ("mask", "cand", "cohort", "stale_buffered", "stale_folded",
                  "stale_expired", "sel", "byz"):
            if k in logs:
                OUT[f"{P}{k}_{r}"] = np.asarray(logs[k])
    met = eng.eval_metrics(eng.carry_params(carry), logs)
    for k in ("acc", "c1c2", "mask_tpr", "mask_fpr"):
        if k in met:
            OUT[P + k] = np.asarray(met[k])
    for i, leaf in enumerate(jax.tree.leaves(eng.carry_params(carry))):
        OUT[f"{P}p_{i:03d}"] = np.asarray(leaf)
    for k, v in carry[1].items():
        OUT[f"{P}state_{k}"] = np.asarray(v)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and results (one subprocess per file)."""
    from test_torch_s6b_layout import run_reference
    return run_reference(REF_ASYNC, tmp_path_factory.mktemp("ref"), {},
                         devices=8)


def _setup(ref, name, attack="sign_flip"):
    """The port's model, config, federation, scenario and initial params
    on the reference's inputs."""
    P = MESHLESS_ONLY.get(name, name) + "/"
    model = zoo_model(ModelConfig(**TINY, dtype="float32",
                                  param_dtype="float32"), seq_len=SEQ)
    cfg = FLConfig(**BASE, **CONFIGS[name], attack=AttackConfig(kind=attack))
    data = FederatedData(torch.from_numpy(ref[P + "x"]).long(),
                         torch.from_numpy(ref[P + "y"]).long(),
                         int(ref[P + "n_classes"]))
    fed = Federation.create(model, data,
                            torch.from_numpy(ref[P + "test_x"]).long(),
                            torch.from_numpy(ref[P + "test_y"]).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    for j in range(cfg.n_clients):
        fed.server.ingest_samples(j, ref[f"{P}sx_{j}"], ref[f"{P}sy_{j}"])
    fed.root_x = torch.from_numpy(ref[P + "root_x"]).long()
    fed.root_y = torch.from_numpy(ref[P + "root_y"]).long()
    cohort = ref.get(P + "cohort")
    scen = sim.make_scenario(cfg, fed, cohort=cohort)
    like = model.init(torch.Generator().manual_seed(0), "cpu")
    p0 = {k: torch.from_numpy(ref[f"p0_{i:03d}"]) for i, k in
          enumerate(like)}
    return model, cfg, fed, scen, p0


def _async_run(ref, name, mesh):
    """Three chained one-round segments on the reference's draws; the
    carry built by ``init_carry`` outside any ``use_mesh``."""
    P = MESHLESS_ONLY.get(name, name) + "/"
    model, cfg, fed, scen, p0 = _setup(ref, name)
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    assert sharding.get_mesh() is None
    carry = eng.init_carry(p0)
    draws = {"batch_idx": torch.from_numpy(ref[P + "batch_idx"]).long(),
             "fault_rows": torch.from_numpy(ref[P + "fault_rows"])}
    gen, lrs = torch.Generator().manual_seed(0), torch.full((1,), LR)
    logs_out = []
    for r in range(cfg.rounds):
        carry, logs = eng.run_segment(carry, gen, lrs, scen, draws={
            k: v[r:r + 1] for k, v in draws.items()})
        logs_out.append({k: logs[k].clone() for k in LOG_KEYS
                         if k in logs})
    met = eng.eval_metrics(eng.carry_params(carry), logs)
    # the carry holds the rank's tiles on a model axis > 1
    return {"params": eng.whole_params(carry[0]), "state": carry[1],
            "logs": logs_out,
            **{k: met[k].numpy() for k in ("acc", "c1c2", "mask_tpr",
                                            "mask_fpr") if k in met}}


def _gaussian_run(mesh, ref):
    """The straggler slab under a gaussian attack, every draw the port's
    own: three rounds, then the generator's next draw."""
    model, cfg, fed, scen, p0 = _setup(ref, "straggler", attack="gaussian")
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    carry, logs = eng.run_segment(p0, gen, torch.full((cfg.rounds,), LR),
                                  scen)
    return {"params": eng.whole_params(carry[0]), "u": carry[1]["u"],
            "logs": {k: logs[k] for k in LOG_KEYS if k in logs},
            "next": torch.randn((8,), generator=gen)}


def _rank_main(rank, world, ref):
    mesh = make_host_mesh(4, 2, device="cpu")
    out = {name: _async_run(ref, name, mesh) for name in CONFIGS}
    out["gaussian"] = _gaussian_run(mesh, ref)
    out["s"] = sharding.model_index(mesh)
    return out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Every fault model and the gaussian run on 8 gloo ranks (a 4 x 2
    mesh), one spawn; the port's meshless runs in this process."""
    ranks = spawn_local(_rank_main, 8, (ref,), timeout=RANK_TIMEOUT,
                        workdir=tmp_path_factory.mktemp("ranks"))
    base = {name: _async_run(ref, name, None) for name in CONFIGS}
    base["gaussian"] = _gaussian_run(None, ref)
    return ranks, base


def _close(got, want, what):
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                         dtype=np.float64)
    tol = 1e-5 * np.abs(w).max() + 1e-6
    assert g.shape == w.shape and np.abs(g - w).max() <= tol, \
        (what, np.abs(g - w).max(), tol)


def _same_metrics(a, b, what):
    keys = [k for k in ("mask_tpr", "mask_fpr", "acc", "c1c2") if k in b]
    assert [k for k in keys if k in a] == keys
    for k in keys[:-1] if "c1c2" in b else keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
    if "c1c2" not in b:
        return
    ca, cb = np.asarray(a["c1c2"]), np.asarray(b["c1c2"])
    np.testing.assert_array_equal(np.sign(ca), np.sign(cb))
    passes = [(np.abs(c) > 0.5) & (np.abs(c) < 2.0) for c in (ca, cb)]
    np.testing.assert_array_equal(*passes)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_async_model_mesh_agrees_with_the_references(name, ref, runs):
    ranks, base = runs
    P = name + "/"
    with_ref = name not in MESHLESS_ONLY
    n_leaves = len(base[name]["params"])
    layout = sharding.blocked_layout(base[name]["params"], 2)
    if with_ref:
        want_p = [ref[f"{P}p_{i:03d}"] for i in range(n_leaves)]
        want = {k: ref[P + k] for k in ("acc", "c1c2", "mask_tpr",
                                        "mask_fpr") if P + k in ref}
        _same_metrics(base[name], want, "meshless")
    else:
        want = {k: v for k, v in base[name].items() if k in (
            "acc", "c1c2", "mask_tpr", "mask_fpr")}
    for rank, out in enumerate(ranks):
        run, s = out[name], out["s"]
        assert s == rank % 2
        _same_metrics(run, want, rank)
        for r, logs in enumerate(run["logs"]):
            assert set(logs) == set(base[name]["logs"][r])
            for k in logs:
                if with_ref:
                    np.testing.assert_array_equal(
                        logs[k].numpy(), ref[f"{P}{k}_{r}"],
                        err_msg=f"{name} rank {rank} round {r + 1} {k}")
                assert torch.equal(logs[k], base[name]["logs"][r][k]), k
        for i, (k, v) in enumerate(run["params"].items()):
            if with_ref:
                _close(v.numpy(), want_p[i], (name, rank, k, "reference"))
            _close(v.numpy(), base[name]["params"][k].numpy(),
                   (name, rank, k, "meshless"))
        state, bstate = run["state"], base[name]["state"]
        assert set(state) == set(bstate)
        for k in state:
            if k == "u":
                # the rank's (B, L) row: the reference's row s of its
                # (B, ms, L) slab, the meshless (B, D) slab's blocked row
                assert tuple(state["u"].shape) == (2, layout.L)
                _close(state["u"].numpy(), ref[P + "state_u"][:, s],
                       (name, rank, "slab"))
                _close(state["u"].numpy(),
                       layout.rows(bstate["u"], s).numpy(),
                       (name, rank, "slab meshless"))
            else:
                if with_ref:
                    np.testing.assert_array_equal(state[k].numpy(),
                                                  ref[f"{P}state_{k}"])
                assert torch.equal(state[k], bstate[k]), k
    if not with_ref:
        # every straggler expires: there is nowhere to land it
        assert sum(int(base[name]["logs"][r]["stale_expired"])
                   for r in range(3)) > 0
    elif "u" in base[name]["state"]:
        # the stragglers really went through the slab
        assert sum(int(ref[f"{P}stale_folded_{r}"]) for r in range(3)) > 0


def test_gaussian_slab_noise_keeps_the_generator_in_step(runs):
    ranks, base = runs
    want = base["gaussian"]
    layout = sharding.blocked_layout(want["params"], 2)
    for out in ranks:
        got = out["gaussian"]
        assert torch.equal(got["next"], want["next"])
        assert set(got["logs"]) == set(want["logs"])
        for k in want["logs"]:
            assert torch.equal(got["logs"][k], want["logs"][k]), k
        for k, v in got["params"].items():
            _close(v.numpy(), want["params"][k].numpy(), ("gaussian", k))
        _close(got["u"].numpy(), layout.rows(want["u"], out["s"]).numpy(),
               "gaussian slab")
