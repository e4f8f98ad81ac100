"""The four repairs that come before the zoo's training path (S6a), on the
CPU against the JAX reference where it has a counterpart:

* the reference's ``FLConfig.use_kernel_stats``/``use_kernel_agg`` knobs
  with their named refusals, ``fl/server.KERNEL_AGG_RULES`` and
  ``fl/simulator.AGGREGATORS``, ``core/aggregators.oracle_sgd`` and
  ``fltrust``;
* the kernel router's refusal of a CUDA call under grad (no kernel has a
  backward), its logic checked with stand-in CUDA operands;
* a bf16 SGD step computed in fp32 and rounded once: within the
  cross-framework rate (at most 1e-4 of the entries one bf16 step off)
  of the reference's jitted step, which the old expression misses;
* JAX's leaf order for flat updates (``convert.leaf_paths``,
  ``flatten_tree``, ``zoo_params_from_jax``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import models as jmodels
from repro.core import aggregators as jagg
from repro.core.diversefl import guiding_update as jax_guiding_update
from repro.fl import FLConfig as JaxFLConfig
from repro.fl import server as jserver
from repro.fl import simulator as jsim
from repro.models import ModelConfig as JaxModelConfig
from repro_torch.convert import (flatten_tree, leaf_paths, unflatten_like,
                                 zoo_params_from_jax)
from repro_torch.core import aggregators as agg
from repro_torch.core.diversefl import guiding_update, sgd_round_once
from repro_torch.fl import FLConfig
from repro_torch.fl import server, simulator
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig
from repro_torch.models import model as tmodel

# the cross-framework rate: at most this share of bf16 entries one step off
BF16_RATE = 1e-4
SGD_N = 100_000


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# 1. The dropped names
# ----------------------------------------------------------------------

def test_registry_names_equal_the_reference():
    assert server.KERNEL_AGG_RULES == jserver.KERNEL_AGG_RULES
    assert simulator.AGGREGATORS == jsim.AGGREGATORS


REFUSALS = [
    dict(use_kernel_agg=True, aggregator="median"),
    dict(use_kernel_agg=True, aggregator="krum"),
    dict(use_kernel_stats=True, streaming=True),
    dict(use_kernel_agg=True, compression="int8"),
]


@pytest.mark.parametrize("kw", REFUSALS)
def test_use_kernel_refusals_carry_the_reference_text(kw):
    with pytest.raises(ValueError) as want:
        JaxFLConfig(**kw)
    with pytest.raises(ValueError) as got:
        FLConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(use_kernel_agg=True), dict(use_kernel_stats=True),
    dict(use_kernel_agg=True, use_kernel_stats=True, streaming=True),
    dict(use_kernel_agg=True, aggregator="fltrust"),
    dict(use_kernel_agg=True, compression="int8", streaming=True)])
def test_reference_shaped_configs_are_accepted(kw):
    JaxFLConfig(**kw)
    c = FLConfig(**kw)
    for k, v in kw.items():
        assert getattr(c, k) == v


def test_oracle_sgd_and_fltrust_match_the_reference():
    rng = np.random.default_rng(3)
    U = rng.normal(size=(7, 300)).astype(np.float32)
    root = rng.normal(size=(300,)).astype(np.float32)
    benign = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    np.testing.assert_allclose(
        agg.oracle_sgd(torch.from_numpy(U), torch.from_numpy(benign)),
        np.asarray(jagg.oracle_sgd(jnp.asarray(U), jnp.asarray(benign))),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        agg.fltrust(torch.from_numpy(U), torch.from_numpy(root)),
        np.asarray(jagg.fltrust(jnp.asarray(U), jnp.asarray(root))),
        rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------
# 2. The gradient refusal
# ----------------------------------------------------------------------

class _CudaStandIn:
    """What ``ops._route`` reads of a CUDA tensor: its host-side flags."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, requires_grad):
        self.requires_grad = requires_grad


ROUTED = ["similarity_stats", "masked_aggregate", "masked_agg_update",
          "dequant_fold_update", "robust_aggregate", "flash_attention",
          "mamba_scan"]


@pytest.mark.parametrize("name", ROUTED)
def test_cuda_route_under_grad_is_refused_by_name(name):
    t, leaf = _CudaStandIn(False), _CudaStandIn(True)
    with torch.enable_grad():
        for args in ((leaf,), (t, leaf), (t, t, leaf)):
            with pytest.raises(ValueError, match=f"^{name}: .*no backward"):
                ops._route(args[0], name, *args[1:])
        assert ops._route(t, name, t) is True
    with torch.no_grad():
        assert ops._route(leaf, name, leaf) is True


def test_cpu_route_under_grad_keeps_the_plain_paths_gradient():
    """A CPU operand that requires grad takes the plain version, which
    autograd differentiates: the flash adapter's q gradient equals
    causal ``scaled_dot_product_attention``'s."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 16, 8), generator=g, requires_grad=True)
    k = torch.randn((1, 2, 16, 8), generator=g)
    with torch.enable_grad():
        assert ops._route(q, "flash_attention", k, k) is False
        (gq,) = torch.autograd.grad(ops.flash_attention_bhsd(q, k, k).sum(),
                                    q)
        (want,) = torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, k, is_causal=True).sum(), q)
    torch.testing.assert_close(gq, want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# 3. One rounding per SGD step
# ----------------------------------------------------------------------

def _bf16_pair(seed, n=SGD_N):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=n).astype(ml_dtypes.bfloat16)
    g = rng.normal(size=n).astype(ml_dtypes.bfloat16)
    return t, g


def _to_torch(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _off_by(got, want, t):
    """(entries that differ, whether each is within one bf16 step of the
    larger magnitude, or, where the step cancels, within the fp32 rounding
    of ``lr * g`` that an FMA keeps and a separate product drops)."""
    got = got.float().numpy()
    want = want.astype(np.float32)
    t = np.abs(t.astype(np.float32))
    diff = got != want
    near = np.abs(got - want) <= (np.maximum(np.abs(got), np.abs(want))
                                  * 2.0 ** -7 + t * 2.0 ** -22)
    return int(diff.sum()), bool(near.all())


@jax.jit
def _jax_step(t, lr, g):
    # the reference's client step (fl/engine.py): lr a strongly typed fp32
    return (t - lr * g).astype(t.dtype)


@pytest.mark.parametrize("lr", [0.05, 0.003])
def test_bf16_sgd_step_rounds_once_like_the_reference(lr):
    t, g = _bf16_pair(11)
    want = np.asarray(_jax_step(jnp.asarray(t), jnp.float32(lr),
                                jnp.asarray(g)))
    tt, gt = _to_torch(t), _to_torch(g)
    for lr_t in (torch.tensor(lr, dtype=torch.float32), lr):
        got = sgd_round_once(tt, lr_t, gt)
        assert got.dtype == torch.bfloat16
        n_off, near = _off_by(got, want, t)
        assert n_off <= BF16_RATE * SGD_N and near, n_off


def test_old_bf16_expression_misses_the_rate():
    """``t - lr * g`` with a 0-d fp32 lr keeps ``lr * g`` in bf16 and
    rounds twice: far more entries off than the rate allows."""
    t, g = _bf16_pair(11)
    want = np.asarray(_jax_step(jnp.asarray(t), jnp.float32(0.05),
                                jnp.asarray(g)))
    old = _to_torch(t) - torch.tensor(0.05) * _to_torch(g)
    n_off, _ = _off_by(old, want, t)
    assert n_off > 10 * BF16_RATE * SGD_N, n_off


def test_fp32_sgd_step_is_the_plain_expression():
    g = torch.Generator().manual_seed(1)
    t, gr = torch.randn(1000, generator=g), torch.randn(1000, generator=g)
    lr = torch.tensor(0.05)
    assert torch.equal(sgd_round_once(t, lr, gr), t - lr * gr)


def test_bf16_guiding_update_matches_the_reference():
    """Three guide steps on bf16 params with a fixed bf16 gradient: the
    fp32 guide within the rate of the reference's jitted one."""
    t, g = _bf16_pair(12, 20_000)
    jp, jg = {"w": jnp.asarray(t)}, {"w": jnp.asarray(g)}
    want = jax.jit(lambda p, lr: jax_guiding_update(
        p, None, lambda th, b: jg, lr, E=3))(jp, jnp.float32(0.05))["w"]
    got = guiding_update({"w": _to_torch(t)}, None,
                         lambda th, b: {"w": _to_torch(g)},
                         torch.tensor(0.05), E=3)["w"]
    assert got.dtype == torch.float32
    diff = got.numpy() != np.asarray(want)
    assert diff.sum() <= BF16_RATE * 20_000 * 3, int(diff.sum())


# ----------------------------------------------------------------------
# 4. JAX's leaf order
# ----------------------------------------------------------------------

TINY = dict(name="fl-llm-tiny", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, attn_direct_max=16)


def test_leaf_paths_follow_jax_leaf_order():
    tree = {"b": [1, {"z": 2, "a": 3}], "a": (4, 5), "10": 6, "2": 7,
            "x-y": 8, "x/y": 9}
    assert [leaf for _, leaf in leaf_paths(tree)] == jax.tree.leaves(tree)
    back = unflatten_like(tree, [leaf for _, leaf in leaf_paths(tree)])
    assert back == tree and list(back) == list(tree)
    with pytest.raises(ValueError, match="more leaves"):
        unflatten_like({"a": 1}, [1, 2])


def test_flat_zoo_params_follow_the_reference_leaf_order():
    """fl-llm-tiny: the port's own init, flattened, and the reference's
    tree carried over, both in jax.tree.leaves' order, keys sorting to
    it; insertion order (the port's tree) differs."""
    jp = jax.tree.map(np.asarray, jmodels.init(jax.random.PRNGKey(0),
                                               JaxModelConfig(**TINY)))
    want = [a.shape for a in jax.tree.leaves(jp)]
    flat = zoo_params_from_jax(jp, "cpu")
    assert [tuple(v.shape) for v in flat.values()] == want
    assert list(flat) == sorted(flat)
    for v, w in zip(flat.values(), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(v.float().numpy(),
                                      w.astype(np.float32))
    tree = tmodel.init(torch.Generator().manual_seed(0), ModelConfig(**TINY),
                       "cpu")
    mine = flatten_tree(tree)
    assert list(mine) == list(flat)
    insertion = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        else:
            insertion.append(tuple(t.shape))
    walk(tree)
    assert insertion != want


def test_flat_keys_sort_in_jax_order_where_paths_would_not():
    """Twelve list entries ("10" < "2" as strings) and the keys "x" and
    "x-y" ("x-y/..." < "x/..." as paths, since "-" < "/"): the padded
    positions sort in JAX's order, the bare paths do not."""
    z = torch.zeros(1)
    tree = {"a": [z.clone() for _ in range(12)], "x": {"y": z.clone()},
            "x-y": z.clone()}
    flat = flatten_tree(tree)
    assert list(flat) == sorted(flat)
    assert list(flat.values()) == [leaf for _, leaf in leaf_paths(tree)]
    assert [id(v) for v in flat.values()] == \
        [id(v) for v in jax.tree.leaves(tree)]
    paths = [k.split(":", 1)[1] for k in flat]
    assert paths != sorted(paths)
