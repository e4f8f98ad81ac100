"""The port's streaming aggregation against the JAX reference, on the CPU.

* Chunking: ``pad_to_blocks``/``unblock``/``block_valid``/
  ``group_blocks``/``group_blocks_2d``/``resolve_*`` against
  ``repro.fl.chunking`` on index arrays, and ``chunked_vmap`` against a
  single batched call.
* The AggState monoid (``tests/test_streaming.py``'s laws): merge
  associativity, the identity, ``update == merge(s, update(init, u))``,
  chunk-order insensitivity; each rule's row fold against the
  reference's; the non-finite guard; the registry and fallback reasons.
* ``stream_aggregate``: the sweep against the dense masked mean, bitwise,
  and its (shards, pods) associations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import chunking as jchunk
from repro.fl.server import AggregationContext as JaxContext
from repro.fl.streaming import get_streaming as jax_get_streaming
from repro_torch.core.diversefl import masked_mean_flat
from repro_torch.fl import chunking
from repro_torch.fl.server import (AggregationContext, SecureServer,
                                   available_aggregators)
from repro_torch.fl.streaming import (NON_STREAMING, fallback_reason,
                                      get_streaming, register_streaming,
                                      stream_aggregate, streaming_rules,
                                      tree_merge)

RULES = ["mean", "oracle", "diversefl", "fltrust"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# chunking
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C,chunk", [(23, 8), (23, 4), (24, 8), (7, 7),
                                     (5, 2), (1, 1)])
def test_blocks_match_the_reference(C, chunk):
    ids = np.arange(C * 3).reshape(C, 3)
    blocks, k, c = chunking.pad_to_blocks((torch.from_numpy(ids),), chunk)
    jblocks, jk, jc = jchunk.pad_to_blocks((jnp.asarray(ids),), chunk)
    assert (k, c) == (jk, jc)
    np.testing.assert_array_equal(blocks[0].numpy(), np.asarray(jblocks[0]))
    np.testing.assert_array_equal(
        chunking.unblock(blocks, k, chunk, C)[0].numpy(), ids)
    np.testing.assert_array_equal(chunking.block_valid(k, chunk, C).numpy(),
                                  np.asarray(jchunk.block_valid(k, chunk, C)))


@pytest.mark.parametrize("k,pods,shards", [(8, 1, 1), (8, 2, 2), (8, 1, 4),
                                           (6, 3, 2), (12, 2, 3)])
def test_groups_match_the_reference(k, pods, shards):
    ids = np.arange(k * 2).reshape(k, 2)
    np.testing.assert_array_equal(
        chunking.group_blocks_2d(torch.from_numpy(ids), k, pods,
                                 shards).numpy(),
        np.asarray(jchunk.group_blocks_2d(jnp.asarray(ids), k, pods, shards)))
    np.testing.assert_array_equal(
        chunking.group_blocks(torch.from_numpy(ids), k, pods * shards).numpy(),
        np.asarray(jchunk.group_blocks(jnp.asarray(ids), k, pods * shards)))


def test_shard_and_pod_counts_resolve_as_the_reference():
    for s in range(1, 9):
        for k in range(1, 9):
            assert chunking.resolve_shards(s, k) == jchunk.resolve_shards(s, k)
            assert chunking.resolve_pods(None, k, s) == \
                jchunk.resolve_pods(None, k, s)
    assert chunking.resolve_pods(2, 4) == 2
    for bad in (0, 3, 5):
        with pytest.raises(chunking.ShardMismatchError):
            chunking.resolve_pods(bad, 4)
    with pytest.raises(chunking.ShardMismatchError, match="must divide"):
        chunking.group_blocks(torch.arange(6), 6, 4)
    with pytest.raises(chunking.ShardMismatchError, match="per-pod shards"):
        chunking.group_blocks_2d(torch.arange(8), 8, 2, 3)
    with pytest.raises(ValueError, match="exceeds the leading axis"):
        chunking.pad_to_blocks((torch.ones(3, 2),), 8)
    assert issubclass(chunking.ShardMismatchError, ValueError)


@pytest.mark.parametrize("n,chunk", [(7, 3), (7, 4), (5, 2), (1, 3), (5, 5),
                                     (5, None)])
def test_chunked_vmap_equals_one_batched_call(n, chunk):
    xs = torch.arange(float(n * 3)).reshape(n, 3)
    b = torch.arange(float(n)) * 0.5

    def fn(a, bb):
        return {"s": a.sum(-1) + bb, "v": a * 2.0}
    want = fn(xs, b)
    got = chunking.chunked_vmap(fn, (xs, b), chunk)
    for key in want:
        assert torch.equal(got[key], want[key])
    assert torch.equal(chunking.chunked_vmap(lambda a, bb: a + 1.0,
                                             (xs, b), chunk), xs + 1.0)


# ----------------------------------------------------------------------
# the AggState monoid
# ----------------------------------------------------------------------

def _bound(name, n, d, seed):
    """A bound port rule, the reference's twin, and both packages' rows
    of (u, ctx) from the same numpy draws."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n, d)).astype(np.float32)
    G = (U * rng.choice([1.0, -1.0, 3.0], size=(n, 1))
         + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    byz = rng.random(n) < 0.3
    root = rng.normal(size=(d,)).astype(np.float32)
    rule = get_streaming(name).bind(AggregationContext(
        byz_mask=torch.from_numpy(byz), guides=torch.from_numpy(G),
        root_update=torch.from_numpy(root)))
    jrule = jax_get_streaming(name).bind(JaxContext(
        byz_mask=jnp.asarray(byz), guides=jnp.asarray(G),
        root_update=jnp.asarray(root)))
    rows = [(torch.from_numpy(U[i]),
             {"guide": torch.from_numpy(G[i]), "byz": torch.tensor(byz[i]),
              "valid": torch.tensor(True)}) for i in range(n)]
    jrows = [(jnp.asarray(U[i]), {"guide": jnp.asarray(G[i]),
                                  "byz": jnp.asarray(byz[i]),
                                  "valid": jnp.asarray(True)})
             for i in range(n)]
    return rule, rows, jrule, jrows


def _fold(rule, rows, d):
    state = rule.init(d)
    for u, ci in rows:
        state, _ = rule.update(state, u, ci)
    return state


def _close(a, b, **tol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@pytest.mark.parametrize("name", RULES)
def test_row_fold_matches_the_reference_rule(name):
    rule, rows, jrule, jrows = _bound(name, 9, 37, seed=1)
    state, jstate = _fold(rule, rows, 37), _fold(jrule, jrows, 37)
    _close(state, jstate, rtol=1e-5, atol=1e-6)
    delta, _ = rule.finalize(state)
    jdelta, _ = jrule.finalize(jstate)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=1e-5,
                               atol=1e-6)
    # the block form's weights are the row form's, client by client
    U = torch.stack([u for u, _ in rows])
    ctx = {k: torch.stack([c[k] for _, c in rows]) for k in rows[0][1]}
    a, b, _ = rule.weights(U, ctx)
    for i, (u, ci) in enumerate(rows):
        s1, _ = rule.update(rule.init(37), u, ci)
        np.testing.assert_allclose(b[i].item(), s1[1].item(), rtol=1e-5)


@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_is_associative(name, seed):
    """One fp add per side, the same operands: tight tolerance."""
    rule, rows, _, _ = _bound(name, 9, 17, seed)
    a, b, c = (_fold(rule, rows[i:i + 3], 17) for i in (0, 3, 6))
    _close(rule.merge(rule.merge(a, b), c), rule.merge(a, rule.merge(b, c)),
           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["mean", "oracle", "diversefl"])
def test_merge_identity_and_exact_associativity(name):
    """Integer-valued updates and 0/1 weights make every add exact: the
    monoid laws hold bitwise and init is the identity."""
    rng = np.random.default_rng(0)
    d = 11
    rule, _, _, _ = _bound(name, 3, d, 0)
    U = torch.from_numpy(rng.integers(-8, 8, size=(6, d)).astype(np.float32))
    rows = [(U[i], {"guide": torch.sign(U[i]), "byz": torch.tensor(False),
                    "valid": torch.tensor(True)}) for i in range(6)]
    a, b, c = (_fold(rule, rows[i:i + 2], d) for i in (0, 2, 4))
    for x, y in zip(rule.merge(rule.merge(a, b), c),
                    rule.merge(a, rule.merge(b, c))):
        assert torch.equal(x, y)
    for x, y in zip(rule.merge(rule.init(d), a), a):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4])
def test_chunk_order_insensitive(name, n_chunks):
    rule, rows, _, _ = _bound(name, 12, 13, seed=n_chunks)
    bounds = np.linspace(0, 12, n_chunks + 1).astype(int)
    parts = [_fold(rule, rows[lo:hi], 13)
             for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    fwd = parts[0]
    for p in parts[1:]:
        fwd = rule.merge(fwd, p)
    rev = parts[-1]
    for p in reversed(parts[:-1]):
        rev = rule.merge(p, rev)
    np.testing.assert_allclose(rule.finalize(fwd)[0].numpy(),
                               rule.finalize(rev)[0].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_update_matches_merge_of_singleton():
    rule, rows, _, _ = _bound("diversefl", 5, 19, seed=3)
    state = _fold(rule, rows[:4], 19)
    via_update, _ = rule.update(state, *rows[4])
    via_merge = rule.merge(state, rule.update(rule.init(19), *rows[4])[0])
    _close(via_update, via_merge, rtol=1e-6, atol=1e-7)


def test_nonfinite_guard_zeroes_the_client_and_keeps_the_delta_finite():
    d = 17
    rng = np.random.default_rng(3)
    U = rng.normal(size=(8, d)).astype(np.float32)
    U[2] = np.nan
    U[5, 0] = np.inf
    rule = get_streaming("mean").bind(AggregationContext())

    def block_fn(blk, valid):
        (u_b,) = blk
        return u_b, {}

    delta, _, logs = stream_aggregate(rule, block_fn, (torch.from_numpy(U),),
                                      4, d=d)
    assert logs["nonfinite"].tolist() == [False, False, True, False, False,
                                          True, False, False]
    fin = np.delete(U, [2, 5], axis=0)
    assert torch.isfinite(delta).all()
    # screened rows add exactly 0 to the numerator and the denominator
    np.testing.assert_allclose(delta.numpy(), fin.sum(0) / len(fin),
                               rtol=1e-6)
    d2, _, logs2 = stream_aggregate(rule, block_fn, (torch.ones(8, d),), 4,
                                    d=d)
    assert not logs2["nonfinite"].any() and torch.equal(d2, torch.ones(d))


def test_registry_and_fallback_reasons():
    assert streaming_rules() == ("mean", "oracle", "diversefl", "fltrust")
    assert set(NON_STREAMING) | set(streaming_rules()) == \
        set(available_aggregators())
    for name in NON_STREAMING:
        assert fallback_reason(name) == NON_STREAMING[name]
        assert get_streaming(name) is None
        assert SecureServer.streaming_aggregator(
            name, AggregationContext()) is None
    assert fallback_reason("diversefl") is None
    assert SecureServer.streaming_aggregator(
        "oracle", AggregationContext(byz_mask=torch.zeros(3, dtype=bool))
    ).finalize is not None
    with pytest.raises(ValueError, match="no dense AggregatorRegistry"):
        register_streaming("not_a_rule")(lambda ctx: None)
    with pytest.raises(ValueError, match="already registered"):
        register_streaming("mean")(lambda ctx: None)


# ----------------------------------------------------------------------
# the sweep
# ----------------------------------------------------------------------

def _oracle_sweep(n, d, chunk, shards=None, pods=None, seed=1):
    rng = np.random.default_rng(seed)
    U = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    byz = torch.from_numpy(rng.random(n) < 0.3)
    rule = get_streaming("oracle").bind(AggregationContext(byz_mask=byz))

    def block_fn(blk, valid):
        u_blk, byz_b = blk
        return u_blk, {"byz": byz_b}
    return U, byz, stream_aggregate(rule, block_fn, (U, byz), chunk, d=d,
                                    shards=shards, pods=pods)


@pytest.mark.parametrize("chunk", [1, 5, 8, 37, None])
def test_stream_aggregate_is_bitwise_the_dense_masked_mean(chunk):
    U, byz, (delta, _, logs) = _oracle_sweep(37, 29, chunk)
    assert torch.equal(delta, masked_mean_flat(U, ~byz))
    assert torch.equal(logs["mask"], ~byz)


@pytest.mark.parametrize("chunk,shards,pods", [(4, 3, None), (3, 2, 2),
                                               (2, 2, 5), (4, 1, 1)])
def test_sharded_and_two_tier_folds(chunk, shards, pods):
    """Other associations of the merge: the per-client logs bitwise, the
    delta to fp tolerance; (1, 1) is the sequential sweep, bitwise."""
    U, byz, (delta, _, logs) = _oracle_sweep(40, 29, chunk, shards, pods)
    want = masked_mean_flat(U, ~byz)
    assert torch.equal(logs["mask"], ~byz)
    np.testing.assert_allclose(delta.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-7)
    if (shards, pods) == (1, 1):
        assert torch.equal(delta, want)
    with pytest.raises(chunking.ShardMismatchError):
        _oracle_sweep(40, 29, 4, pods=3)


def test_tree_merge_order_is_canonical():
    """Five states (s0..s4) merge as ((s0 s1)(s2 s3)) s4, whatever their
    values: recorded through a merge that writes its association."""
    merged = tree_merge(lambda a, b: f"({a} {b})",
                        [f"s{i}" for i in range(5)])
    assert merged == "(((s0 s1) (s2 s3)) s4)"
    assert tree_merge(lambda a, b: a + b, ["only"]) == "only"
