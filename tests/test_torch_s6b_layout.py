"""The port's sharding layout (``repro_torch.sharding``) in one process,
against the reference's ``repro.sharding``.

* The blocked ``(ms, L)`` layout: ``flatten_updates_sharded``, its
  ``unravel`` and ``ravel_sharded`` at ms in {1, 2, 4}, on gemma-2b's
  SMOKE params and on a tree with leaves that do not tile, bitwise equal
  to the reference's (computed in a subprocess on a host mesh of 4 forced
  devices, inputs and outputs passed as ``.npz``).
* The twins of ``tests/test_model_fl.py``'s meshless layout tests.
* ``partition_pytree`` for all ten configs against the reference's, leaf
  by leaf.

``run_reference`` (the reference subprocess runner) lives here; the other
``test_torch_s6b_*`` files import it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.convert import flatten_tree, leaf_paths, unflatten_like
from repro_torch.core.aggregators import flatten_updates
from repro_torch.fl import weighted_mean_rule
from repro_torch.fl.streaming import flat_ndim, stat_sum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 22


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_reference(script: str, tmp_path, inputs: dict, devices: int,
                  timeout: int = 300) -> dict:
    """Run ``script`` in a JAX subprocess on ``devices`` forced host
    devices.  The script reads ``IN`` (a dict of the ``inputs`` arrays)
    and fills ``OUT`` (a dict of numpy arrays), which is returned.  Its
    preamble points ``jax.core.trace_state_clean`` at its JAX 0.9 home
    (the reference's guide cache calls the old name)."""
    src, dst = tmp_path / "ref_in.npz", tmp_path / "ref_out.npz"
    np.savez(src, **inputs)
    pre = textwrap.dedent(f"""
        import sys
        import numpy as np
        import jax
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
        IN = dict(np.load({str(src)!r}))
        OUT = {{}}
    """)
    post = f"\nnp.savez({str(dst)!r}, **OUT)\nprint('OK')\n"
    env = dict(os.environ)
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               TF_CPP_MIN_LOG_LEVEL="2", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c",
                        pre + textwrap.dedent(script) + post],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    assert p.returncode == 0 and "OK" in p.stdout, \
        f"stdout:\n{p.stdout}\nstderr:\n{p.stderr[-4000:]}"
    return dict(np.load(dst))


def _odd_tree(n):
    """Leaves whose model dim tiles, one that does not (embed's V = 6 at
    ms = 4) and one that pads (norm_b, size 5)."""
    rng = np.random.default_rng(SEED)
    return {"wq": rng.standard_normal((n, 2, 4, 8)).astype(np.float32),
            "embed": rng.standard_normal((n, 6, 4)).astype(np.float32),
            "norm_b": rng.standard_normal((n, 5)).astype(np.float32),
            "w_down": rng.standard_normal((n, 2, 8, 4)).astype(np.float32)}


def _gemma_leaves(n):
    """gemma-2b SMOKE params' leaf shapes, n clients, numpy normals."""
    like = models.init(None, configs.get("gemma-2b", smoke=True), "meta")
    rng = np.random.default_rng(SEED + 1)
    return like, [rng.standard_normal((n,) + tuple(v.shape)).astype(
        np.float32) for _, v in leaf_paths(like)]


REF_LAYOUT = """
import jax.numpy as jnp
from repro import configs, models
from repro.launch.mesh import make_host_mesh
from repro.sharding import flatten_updates_sharded, ravel_sharded, use_mesh

like = jax.eval_shape(lambda: models.init(jax.random.PRNGKey(0),
                                          configs.get("gemma-2b", smoke=True)))
treedef = jax.tree.structure(like)
trees = {
    "odd": {k[4:]: jnp.asarray(v) for k, v in IN.items()
            if k.startswith("odd_")},
    "gemma": jax.tree.unflatten(treedef, [
        jnp.asarray(IN[f"gemma_{i:03d}"])
        for i in range(treedef.num_leaves)]),
}
for ms in (1, 2, 4):
    with use_mesh(make_host_mesh(data=4 // ms, model=ms)):
        for name, tree in trees.items():
            blk, unravel = flatten_updates_sharded(tree)
            OUT[f"{name}_{ms}_blocked"] = np.asarray(blk)
            OUT[f"{name}_{ms}_ravel"] = np.asarray(ravel_sharded(
                jax.tree.map(lambda u: u[1], tree)))
            back = jax.tree.leaves(unravel(blk[0]))
            for i, leaf in enumerate(back):
                OUT[f"{name}_{ms}_unravel_{i:03d}"] = np.asarray(leaf)
"""


def test_blocked_layout_is_the_references(tmp_path):
    odd = _odd_tree(2)
    like, gemma = _gemma_leaves(2)
    inputs = {f"odd_{k}": v for k, v in odd.items()}
    inputs.update({f"gemma_{i:03d}": v for i, v in enumerate(gemma)})
    ref = run_reference(REF_LAYOUT, tmp_path, inputs, devices=4)
    trees = {
        "odd": {k: torch.from_numpy(v) for k, v in odd.items()},
        "gemma": unflatten_like(like, [torch.from_numpy(v)
                                       for v in gemma]),
    }
    for ms in (1, 2, 4):
        for name, tree in trees.items():
            blk, unravel = sharding.flatten_updates_sharded(tree, ms=ms)
            np.testing.assert_array_equal(
                blk.numpy(), ref[f"{name}_{ms}_blocked"], f"{name} {ms}")
            one = unflatten_like(tree, [u[1] for _, u in leaf_paths(tree)])
            np.testing.assert_array_equal(
                sharding.ravel_sharded(one, ms=ms).numpy(),
                ref[f"{name}_{ms}_ravel"], f"{name} {ms}")
            back = [v for _, v in leaf_paths(unravel(blk[0]))]
            for i, (leaf, (_, u)) in enumerate(zip(back,
                                                   leaf_paths(tree))):
                want = ref[f"{name}_{ms}_unravel_{i:03d}"]
                np.testing.assert_array_equal(leaf.numpy(), want)
                assert torch.equal(leaf, u[0])


def test_blocked_rows_equal_the_blocked_matrix():
    """``BlockedLayout.rows`` (a model rank's row, from the flat matrix)
    is row s of the blocked build, for every s."""
    tree = {k: torch.from_numpy(v) for k, v in _odd_tree(3).items()}
    flat, _ = flatten_updates(tree)
    for ms in (1, 2, 4):
        blk, _ = sharding.flatten_updates_sharded(tree, ms=ms)
        layout = sharding.blocked_layout({k: v[0] for k, v in tree.items()},
                                         ms)
        assert layout.L == blk.shape[2]
        for s in range(ms):
            assert torch.equal(layout.rows(flat, s), blk[:, s])


# ----------------------------------------------------------------------
# twins of tests/test_model_fl.py's meshless layout tests
# ----------------------------------------------------------------------

def _tree():
    return {k: torch.from_numpy(v) for k, v in _odd_tree(3).items()}


def test_blocked_flatten_ms1_matches_historical_ravel_order():
    upd = _tree()
    blk, _ = sharding.flatten_updates_sharded(upd)
    ref, _ = flatten_updates(upd)
    assert blk.shape == (3, 1, ref.shape[1])
    assert torch.equal(blk[:, 0, :], ref)


def test_blocked_unravel_roundtrip_bitwise():
    upd = _tree()
    blk, unravel = sharding.flatten_updates_sharded(upd)
    out = unravel(blk[1])
    assert set(out) == set(upd)
    for k in upd:
        assert torch.equal(out[k], upd[k][1]), k


def test_ravel_sharded_matches_the_stacked_layout():
    upd = _tree()
    blk, _ = sharding.flatten_updates_sharded(upd)
    vec = sharding.ravel_sharded({k: v[0] for k, v in upd.items()})
    assert torch.equal(vec, blk[0])


def test_stat_sum_is_last_axis_sum_meshless():
    assert flat_ndim() == 1
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 7), generator=gen)
    assert torch.equal(stat_sum(x), x.sum(-1))
    v = torch.randn((7,), generator=gen)
    assert torch.equal(stat_sum(v), v.sum(-1))


def test_weighted_mean_rule_init_accepts_blocked_shape():
    rule = weighted_mean_rule(
        lambda u, ci: (torch.ones(u.shape[:-1]),) * 2 + ({},))
    s1, n1 = rule.init(12)
    s2, n2 = rule.init((4, 3))
    assert s1.shape == (12,) and s2.shape == (4, 3)
    assert n1.shape == () and n2.shape == ()


# ----------------------------------------------------------------------
# the partition table on the zoo
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_partition_pytree_is_the_references(arch):
    """Every leaf's spec equals the reference's for the SMOKE config; the
    port's flat zoo keys (zero-padded positions) map to the same specs."""
    import jax
    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.sharding import partition_pytree as jax_partition
    jp = jax.eval_shape(lambda: jmodels.init(jax.random.PRNGKey(0),
                                             jconfigs.get(arch, smoke=True)))
    want = [tuple(s) for s in jax.tree.leaves(
        jax_partition(jp), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))]
    like = models.init(None, configs.get(arch, smoke=True), "meta")
    assert _spec_leaves(sharding.partition_pytree(like)) == want
    flat = sharding.partition_pytree(flatten_tree(like))
    assert list(flat.values()) == want
    assert any(MODEL in s for s in want)


MODEL = sharding.MODEL_AXIS


def _spec_leaves(tree):
    """Spec tuples of a partition tree in JAX's leaf order (a spec is a
    tuple of names, not a container)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], dict)):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]
