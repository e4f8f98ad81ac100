"""Shared builders of the round-engine tests (``tests/test_torch_engine.py``,
``test_torch_async.py``, ``test_torch_telemetry.py``,
``test_torch_sweep.py``): a small federation made with numpy for both
packages, the port's runs on the CPU, and the reference's draws rebuilt
from its key chain."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.data import FederatedData as JaxFederatedData
from repro.data import partition_sorted_shards as jax_partition
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import Federation as JaxFederation
from repro.fl.faults import FaultConfig as JaxFaultConfig
from repro.fl.small_models import softmax_regression as jax_softmax
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData, partition_sorted_shards
from repro_torch.fl import FLConfig, Federation, softmax_regression
from repro_torch.optim import inv_sqrt_lr

N, DIM, K, PER = 10, 16, 4, 24
FED_SEED = 3


def numpy_data(n, seed):
    """Class-centred Gaussian data, the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(77).normal(size=(K, DIM)) * 2.0
    y = rng.integers(0, K, size=n)
    x = centers[y] + rng.normal(size=(n, DIM))
    return x.astype(np.float32), y.astype(np.int32)


def port_data():
    x, y = numpy_data(N * PER, 0)
    tx, ty = numpy_data(120, 9)
    data = FederatedData.from_partitions(
        partition_sorted_shards(torch.from_numpy(x),
                                torch.from_numpy(y).long(), N), K)
    return data, torch.from_numpy(tx), torch.from_numpy(ty).long()


def model():
    return softmax_regression(input_dim=DIM, n_classes=K)


def cfg(**kw):
    """A small port config: N clients, f = 2 under sign_flip."""
    base = dict(n_clients=N, f=2, rounds=5, eval_every=2, batch_size=4,
                sample_frac=0.2, attack=AttackConfig(kind="sign_flip"))
    base.update(kw)
    return FLConfig(**base)


def federation(c, data=None):
    """The port's federation on the CPU, from a fixed generator, so runs
    of one config see the same enclave samples and root set."""
    data, tx, ty = port_data() if data is None else data
    return Federation.create(model(), data, tx, ty, c,
                             torch.Generator().manual_seed(FED_SEED),
                             device="cpu")


def same_history(a, b):
    """Two histories bit for bit: eval rounds, every metric, params."""
    if a["round"] != b["round"] or set(a) != set(b):
        return False
    for k in ("acc", "mask_tpr", "mask_fpr"):
        if a[k] != b[k]:
            return False
    if any(not np.array_equal(x, y) for x, y in zip(a["c1c2"], b["c1c2"])):
        return False
    return all(torch.equal(a["params"][k], b["params"][k])
               for k in a["params"])


LR = inv_sqrt_lr(0.05)


# ----------------------------------------------------------------------
# The reference side
# ----------------------------------------------------------------------

def jax_cfg(c: FLConfig):
    """The reference config of a port config (the fields the engine
    tests use)."""
    f = c.fault
    return JaxFLConfig(
        n_clients=c.n_clients, f=c.f, rounds=c.rounds,
        eval_every=c.eval_every, batch_size=c.batch_size,
        sample_frac=c.sample_frac, aggregator=c.aggregator,
        attack=JaxAttackConfig(kind=c.attack.kind, sigma=c.attack.sigma,
                               scale=c.attack.scale),
        streaming=c.streaming, client_chunk=c.client_chunk,
        compression=c.compression,
        telemetry=c.telemetry,
        fault=JaxFaultConfig(kind=f.kind, rate=f.rate, delay=f.delay,
                             mode=f.mode, bitflip_scale=f.bitflip_scale),
        cohort_participation=c.cohort_participation,
        staleness_buffer=c.staleness_buffer,
        staleness_cap=c.staleness_cap,
        staleness_discount=c.staleness_discount, seed=c.seed)


def jax_federation(jc):
    x, y = numpy_data(N * PER, 0)
    tx, ty = numpy_data(120, 9)
    jdata = JaxFederatedData.from_partitions(jax_partition(x, y, N), K)
    jmodel = jax_softmax(input_dim=DIM, n_classes=K)
    jfed = JaxFederation.create(jmodel, jdata, jnp.asarray(tx),
                                jnp.asarray(ty), jc, jax.random.PRNGKey(2))
    return jmodel, jfed


def reference_draws(jc, jdata):
    """The reference's per-round draws rebuilt from its key chain
    (``key, sub = split(key)``; ``kb, ka, kr, ks = split(sub, 4)``): the
    (R, N, E·m) minibatch indices from ``kb`` and, with a fault rate, the
    (R, N) fault rows from ``ks``."""
    E, m, n = 1, jc.batch_size, jc.n_clients
    key = jax.random.PRNGKey(jc.seed)
    idx, faults = [], []
    for _ in range(jc.rounds):
        key, sub = jax.random.split(key)
        kb, _ka, _kr, ks = jax.random.split(sub, 4)
        keys = jax.random.split(kb, n)
        idx.append(np.stack([np.asarray(jax.random.randint(
            k, (E * m,), 0, jdata.per_client)) for k in keys]))
        if jc.fault.kind != "none" and jc.fault.rate > 0:
            faults.append(np.asarray(jax.random.uniform(ks, (n,))
                                     < jnp.float32(jc.fault.rate)))
    draws = {"batch_idx": torch.from_numpy(np.stack(idx)).long()}
    if faults:
        draws["fault_rows"] = torch.from_numpy(np.stack(faults))
    return draws


def reference_cohort(jc):
    """The reference's (R, N) cohort chain, or None."""
    from repro.fl.engine import _COHORT_FOLD
    from repro.fl.faults import make_cohort_chain
    if jc.cohort_participation is None:
        return None
    return np.array(make_cohort_chain(
        jc.n_clients, jc.rounds, jc.cohort_participation,
        jax.random.fold_in(jax.random.PRNGKey(jc.seed), _COHORT_FOLD)))


def port_fed_like(c, jfed):
    """The port's federation holding the reference's sealed samples."""
    fed = federation(c)
    for j in range(c.n_clients):
        sx, sy = jfed.server.enclave.unseal_samples(j)
        fed.server.ingest_samples(j, np.asarray(sx), np.asarray(sy))
    return fed
