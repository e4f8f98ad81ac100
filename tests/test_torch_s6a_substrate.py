"""The substrate of the zoo's training path (S6a) against the JAX
reference, on the CPU: ``data/synthetic.make_token_stream`` bitwise on the
reference's injected draws and ``fl/zoo.make_zoo_data`` on them;
``optim/adam`` to 1e-6 on a tree (and converging on the reference's
quadratic); ``checkpoint/store`` round trips through the npz in both
directions, bitwise; the package exports.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.data.synthetic import make_token_stream as jax_token_stream
from repro.fl import zoo as jzoo
from repro.models import ModelConfig as JaxModelConfig
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_step as jax_adam_step
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import tree_from_jax
from repro_torch.data import make_token_stream
from repro_torch.fl import make_zoo_data, zoo_model
from repro_torch.models import ModelConfig
from repro_torch.optim import adam_init, adam_step


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_draws(key, n, s, vocab):
    """make_token_stream's two draws, rebuilt from the reference's key."""
    k1, k2 = jax.random.split(key)
    u = np.array(jax.random.uniform(k1, (n, s), minval=1e-6, maxval=1.0))
    shift = np.array(jax.random.randint(k2, (n, 1), 0, vocab))
    return torch.from_numpy(u), torch.from_numpy(shift)


# ----------------------------------------------------------------------
# Token data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,s,vocab", [(4096, 65, 32_000), (300, 9, 64)])
def test_token_stream_is_bitwise_the_reference(n, s, vocab):
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_token_stream(key, n, s, vocab))
    u, shift = _reference_draws(key, n, s, vocab)
    got = make_token_stream(None, n, s, vocab, u=u, shift=shift)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_token_stream_draws_from_a_generator():
    a = make_token_stream(torch.Generator().manual_seed(0), 50, 7, 100)
    b = make_token_stream(torch.Generator().manual_seed(0), 50, 7, 100)
    assert torch.equal(a, b) and a.shape == (50, 7)
    assert int(a.min()) >= 0 and int(a.max()) < 100
    # the Zipf ranks make one id per sequence (its shift) the commonest
    assert (a == a[:, :1]).float().mean() > 0.2
    with pytest.raises(ValueError, match=r"u must be \(50, 7\)"):
        make_token_stream(None, 50, 7, 100, u=torch.rand(50, 6),
                          shift=torch.zeros(50, 1))


def test_zoo_data_splits_the_reference_stream():
    """make_zoo_data on the reference's draws: the reference's clients'
    (x, y) and test split, token for token."""
    mc = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=64)
    jm = jzoo.zoo_model(JaxModelConfig(**mc), seq_len=8)
    key = jax.random.PRNGKey(9)
    jdata, jtx, jty = jzoo.make_zoo_data(key, jm, 4, 16, n_test=32)
    u, shift = _reference_draws(key, 4 * 16 + 32, 9, 64)
    data, tx, ty = make_zoo_data(None, zoo_model(ModelConfig(**mc),
                                                 seq_len=8),
                                 4, 16, 32, u=u, shift=shift)
    for got, want in ((data.x, jdata.x), (data.y, jdata.y), (tx, jtx),
                      (ty, jty)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert data.n_classes == 64 and data.per_client == 16


# ----------------------------------------------------------------------
# Adam
# ----------------------------------------------------------------------

def _tree(rng):
    return {"b": [rng.normal(size=(3,)).astype(np.float32)],
            "a": {"w": rng.normal(size=(4, 5)).astype(np.float32),
                  "s": np.float32(rng.normal())}}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_the_reference_on_a_tree(wd):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jp, jst = jax.tree.map(jnp.asarray, p0), jax_adam_init(p0)
    tp = tree_from_jax(p0, "cpu")
    st = adam_init(tp)
    assert st["t"].dtype == torch.int32 and int(st["t"]) == 0
    for g in grads:
        jp, jst = jax_adam_step(jp, jax.tree.map(jnp.asarray, g), jst,
                                lr=0.01, weight_decay=wd)
        tp, st = adam_step(tp, tree_from_jax(g, "cpu"), st, lr=0.01,
                           weight_decay=wd)
    assert int(st["t"]) == int(jst["t"]) == 5
    for got, want in ((tp, jp), (st["m"], jst["m"]), (st["v"], jst["v"])):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_adam_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    st = adam_init(p)
    assert st["m"]["w"].dtype == torch.float32
    p2, st = adam_step(p, {"w": torch.full((8,), 0.5, dtype=torch.bfloat16)},
                       st, lr=1e-3)
    assert p2["w"].dtype == torch.bfloat16
    want = jax_adam_step({"w": jnp.ones(8, jnp.bfloat16)},
                         {"w": jnp.full((8,), 0.5, jnp.bfloat16)},
                         jax_adam_init({"w": jnp.ones(8, jnp.bfloat16)}),
                         lr=1e-3)[0]["w"]
    np.testing.assert_array_equal(p2["w"].float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_adam_converges_on_quadratic():
    """The reference's own check (tests/test_substrate.py)."""
    p = {"w": torch.tensor(5.0)}
    st = adam_init(p)
    for _ in range(200):
        p, st = adam_step(p, {"w": 2 * p["w"]}, st, lr=0.1)
    assert abs(float(p["w"])) < 0.1


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------

def _jax_tree():
    return {"b": [jnp.arange(3.0), jnp.full((2, 2), 1.5, jnp.bfloat16)],
            "a": (jnp.arange(4, dtype=jnp.int32),
                  {"z": jnp.zeros(1), "y": jnp.asarray([0.1, -3.0],
                                                       jnp.bfloat16)})}


def _bitwise(got, want):
    a_leaves, b_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            assert str(a.dtype) == f"torch.{b.dtype}"
            np.testing.assert_array_equal(a.numpy(), b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes; the port reads the npz with ``like=``."""
    jt = _jax_tree()
    jax_save(str(tmp_path), 3, jt)
    jax_save(str(tmp_path), 12, jt)
    like = tree_from_jax(jax.tree.map(np.asarray, jt), "cpu")
    assert latest_step(str(tmp_path)) == 12
    got, step = restore_checkpoint(str(tmp_path), like=like, device="cpu")
    assert step == 12 and list(got) == list(like)
    _bitwise(got, jax.tree.map(np.asarray, jt))
    with pytest.raises(FileNotFoundError, match="like="):
        restore_checkpoint(str(tmp_path), 3, device="cpu")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port writes; its own sidecar restores the tree, and the
    reference reads the npz's leaves in its leaf order (given the treedef
    sidecar it keeps, bf16 leaves come back as their raw 2-byte
    pattern, as from its own checkpoints)."""
    jt = _jax_tree()
    tree = tree_from_jax(jax.tree.map(np.asarray, jt), "cpu")
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007.npz"
    got, step = restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 7 and type(got["a"]) is tuple and type(got["b"]) is list
    _bitwise(got, jax.tree.map(np.asarray, jt))
    with open(path + ".treedef", "wb") as f:
        pickle.dump(jax.tree.structure(jt), f)
    back, step = jax_restore(str(tmp_path))
    assert step == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            a = a.view(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), device="cpu")


# ----------------------------------------------------------------------
# Exports
# ----------------------------------------------------------------------

def test_slice_names_are_exported_like_the_reference():
    import repro.checkpoint
    import repro.data
    import repro.fl
    import repro.optim
    import repro_torch.checkpoint
    import repro_torch.data
    import repro_torch.fl
    import repro_torch.optim
    for ref, port, names in (
            (repro.fl, repro_torch.fl, ["ZooModel", "zoo_model",
                                        "make_zoo_data",
                                        "make_zoo_federation"]),
            (repro.optim, repro_torch.optim, ["adam_init", "adam_step"]),
            (repro.checkpoint, repro_torch.checkpoint,
             ["save_checkpoint", "restore_checkpoint", "latest_step"]),
            (repro.data, repro_torch.data, ["make_token_stream"])):
        for n in names:
            assert hasattr(ref, n) and hasattr(port, n), n
