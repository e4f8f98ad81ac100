"""The port's main path as a whole, on the CPU: DiverseFL (Algorithm 1)
with softmax regression and 23 non-IID clients.

* With injected draws, the port's rounds match the reference round body
  (``repro.fl.engine.make_round_body``) round for round.
* With the port's own RNG, 60 rounds meet the reference's acceptance bars
  (``tests/test_system.py``).
* The package rules: no import of JAX or of the reference, and no entry
  point that runs on the CPU unless asked to.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.data import FederatedData as JaxFederatedData
from repro.data import partition_sorted_shards as jax_partition
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import Federation as JaxFederation
from repro.fl.engine import make_round_body as jax_make_round_body
from repro.fl.small_models import softmax_regression as jax_softmax
from repro.optim import inv_sqrt_lr as jax_inv_sqrt_lr
from repro_torch.convert import params_from_jax
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import (FederatedData, make_mnist_like,
                              partition_sorted_shards)
from repro_torch.fl import (FLConfig, Federation, make_round_body,
                            run_federated_training, softmax_regression)
from repro_torch.optim import inv_sqrt_lr

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_CLIENTS, F = 23, 5


@pytest.fixture
def jax_guide_shim(monkeypatch):
    """The reference's guide cache calls ``jax.core.trace_state_clean``,
    which JAX 0.9 moved to ``jax._src.core``.  Point the old name at it for
    this test only."""
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _numpy_mnist_like(n, seed):
    """MNIST-shaped class-template data, made with numpy for both packages."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).normal(size=(10, 784))
    y = rng.integers(0, 10, size=n)
    x = templates[y] + 0.5 * rng.normal(size=(n, 784))
    return x.reshape(n, 28, 28).astype(np.float32), y.astype(np.int32)


@pytest.mark.parametrize("use_kernel_agg", [False, True])
def test_rounds_match_the_reference_with_injected_draws(jax_guide_shim,
                                                        use_kernel_agg):
    """10 rounds of diversefl under sign_flip from the same minibatches and
    the same sealed samples: the same masks every round, and params within
    fp32 tolerance (atol 1e-5, rtol 1e-4).  ``use_kernel_agg`` routes the
    reference through its Pallas kernels (interpret mode); the port always
    goes through its kernel ops."""
    x, y = _numpy_mnist_like(4600, seed=0)
    tx, ty = _numpy_mnist_like(300, seed=9)
    rounds, m = 10, 50
    jcfg = JaxFLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                       aggregator="diversefl",
                       attack=JaxAttackConfig(kind="sign_flip"),
                       batch_size=m, use_kernel_agg=use_kernel_agg)
    jmodel = jax_softmax()
    jdata = JaxFederatedData.from_partitions(
        jax_partition(x, y, N_CLIENTS), 10)
    jfed = JaxFederation.create(jmodel, jdata, jnp.asarray(tx),
                                jnp.asarray(ty), jcfg, jax.random.PRNGKey(2))
    body = jax_make_round_body(jmodel, jfed, jcfg)
    jstep = jax.jit(lambda p, k, lr, b: body(p, k, lr, batch=b))

    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=rounds,
                   aggregator="diversefl", attack=AttackConfig(kind="sign_flip"),
                   batch_size=m)
    model = softmax_regression()
    data = FederatedData.from_partitions(
        partition_sorted_shards(torch.from_numpy(x),
                                torch.from_numpy(y).long(), N_CLIENTS), 10)
    fed = Federation.create(model, data, torch.from_numpy(tx),
                            torch.from_numpy(ty).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    # the reference's sealed samples, read back through its enclave
    for j in range(N_CLIENTS):
        sx, sy = jfed.server.enclave.unseal_samples(j)
        fed.server.ingest_samples(j, np.asarray(sx), np.asarray(sy))
    step = make_round_body(model, fed, cfg)
    np.testing.assert_array_equal(fed.byz_mask.numpy(),
                                  np.asarray(jfed.byz_mask))

    jparams = jmodel.init(jax.random.PRNGKey(1))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    draw = np.random.default_rng(5)
    rows = np.arange(N_CLIENTS)[:, None]
    jxs, jys = np.asarray(jdata.x), np.asarray(jdata.y)
    for r in range(1, rounds + 1):
        idx = draw.integers(0, jdata.per_client, size=(N_CLIENTS, m))
        lr = jax_inv_sqrt_lr(0.05)(r)
        jparams, jlogs = jstep(jparams, jax.random.PRNGKey(r), lr,
                               (jnp.asarray(jxs[rows, idx]),
                                jnp.asarray(jys[rows, idx])))
        with torch.no_grad():
            params, logs = step(params, inv_sqrt_lr(0.05)(r),
                                batch_idx=torch.from_numpy(idx))
        np.testing.assert_array_equal(logs["mask"].numpy(),
                                      np.asarray(jlogs["mask"]),
                                      err_msg=f"round {r}")
        for k in jparams:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"round {r} {k}")
    # the attack was live and the criterion caught it
    assert not logs["mask"][fed.byz_mask].any()


@pytest.fixture(scope="module")
def paper_data():
    x, y = make_mnist_like(torch.Generator().manual_seed(0), 4600)
    tx, ty = make_mnist_like(torch.Generator().manual_seed(9), 1000)
    return (FederatedData.from_partitions(
        partition_sorted_shards(x, y, N_CLIENTS), 10), tx, ty)


def _run(paper_data, aggregator, attack):
    data, tx, ty = paper_data
    model = softmax_regression()
    cfg = FLConfig(n_clients=N_CLIENTS, f=F, rounds=60, aggregator=aggregator,
                   attack=AttackConfig(kind=attack, sigma=1e4), batch_size=50,
                   eval_every=60)
    fed = Federation.create(model, data, tx, ty, cfg, device="cpu")
    return run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))


def test_paper_configuration_meets_the_reference_bars(paper_data):
    """The reference's bars (tests/test_system.py) with the port's own RNG:
    diversefl within 3 points of oracle with perfect detection under
    sign_flip, and far above the undefended mean under gaussian."""
    h_dfl = _run(paper_data, "diversefl", "sign_flip")
    h_orc = _run(paper_data, "oracle", "sign_flip")
    assert h_dfl["final_acc"] >= h_orc["final_acc"] - 0.03
    assert h_dfl["mask_tpr"][-1] == 1.0 and h_dfl["mask_fpr"][-1] == 0.0
    h_dfg = _run(paper_data, "diversefl", "gaussian")
    h_mean = _run(paper_data, "mean", "gaussian")
    assert h_dfg["mask_tpr"][-1] == 1.0 and h_dfg["mask_fpr"][-1] == 0.0
    assert h_dfg["final_acc"] > h_mean["final_acc"] + 0.3
    assert set(h_dfl) == {"round", "acc", "mask_tpr", "mask_fpr", "c1c2",
                          "final_acc", "params", "streaming_fallback",
                          "uplink_bytes_per_client", "uplink_bytes_per_round",
                          "downlink_bytes_per_round",
                          "dense_uplink_bytes_per_round", "uplink_reduction"}
    assert h_dfl["round"] == [60] and h_dfl["c1c2"][-1].shape == (N_CLIENTS,)
    assert h_mean["mask_tpr"] == [] and h_mean["c1c2"] == []


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py", ROOT / "kernel_probe.py"]


def test_port_imports_neither_jax_nor_the_reference():
    banned = {"jax", "jaxlib", "repro"}
    files = _port_files()
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & banned, f"{path}: imports {roots & banned}"


def test_entry_points_without_a_device_refuse_to_run_on_the_cpu(
        monkeypatch, paper_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, tx, ty = paper_data
    model = softmax_regression()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Federation.create(model, data, tx, ty, FLConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"b": np.zeros(10, np.float32)})
