"""The knobs of the port's mesh slice, in one process, against the
reference where it has the same function.

* ``FLConfig.validate_model_sharding``: the twins of
  ``tests/test_model_fl.py``'s refusals, each text equal to the
  reference's.
* ``comm_stats(model_shards=)`` equal to the reference's.
* ``launch.train.resolve_update_dtype``'s two errors (texts equal to the
  reference's) and ``update_psum_dtype``'s gate.
* ``launch.shapes``: the registry and ``applicable`` (twins of
  ``tests/test_launch_shapes.py``), ``train_inputs`` and ``serve_inputs``
  as meta tensors with their placements.
* Off-mesh every sharding helper is the identity; the mesh constructors
  refuse a missing process group by name; ``ShardMismatchError`` is one
  class; the serve functions take the reference's ``mesh``.
"""
import inspect

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.fl import FLConfig as JaxFLConfig
from repro.fl.metrics import comm_stats as jax_comm_stats
from repro.launch.shapes import SHAPES as JAX_SHAPES
from repro.launch.train import resolve_update_dtype as jax_resolve
from repro_torch import configs, sharding
from repro_torch.fl import FLConfig, chunking
from repro_torch.fl.compression import get_codec
from repro_torch.fl.metrics import comm_stats
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.launch.shapes import (SHAPES, InputShape, applicable, sds,
                                       serve_inputs, train_inputs)
from repro_torch.launch.train import (resolve_update_dtype, sharded_param_specs,
                                      update_psum_dtype)


def _kw(**kw):
    base = dict(n_clients=4, f=1, rounds=2, batch_size=2, l2=0.0,
                aggregator="diversefl", streaming=True)
    base.update(kw)
    return base


def _both(call, **kw):
    """(port text, reference text) of the ValueError ``call(cfg)`` raises
    on each package's FLConfig."""
    out = []
    for cls in (FLConfig, JaxFLConfig):
        with pytest.raises(ValueError) as e:
            call(cls(**_kw(**kw)))
        out.append(str(e.value))
    return out


def test_validate_model_sharding_noop_at_ms1():
    FLConfig(**_kw(streaming=False)).validate_model_sharding(100, 1)


@pytest.mark.parametrize("case", [
    ("streaming", dict(streaming=False),
     lambda c: c.validate_model_sharding(100, 2)),
    ("cannot stream", dict(aggregator="median"),
     lambda c: c.validate_model_sharding(
         100, 2, streaming_fallback="order statistics")),
    ("use_kernel_agg", dict(use_kernel_agg=True),
     lambda c: c.validate_model_sharding(100, 2)),
    ("use_kernel_stats", dict(aggregator="fltrust", use_kernel_stats=True),
     lambda c: c.validate_model_sharding(100, 2)),
    ("pad-free", dict(compression="bf16"),
     lambda c: c.validate_model_sharding(128, 2, leaf_sizes=(64, 63, 1))),
    ("QBLOCK", dict(compression="int8"),
     lambda c: c.validate_model_sharding(
         get_codec("int8").qblock * 3, 2,
         leaf_sizes=(get_codec("int8").qblock * 3,))),
    ("straddle shard", dict(compression="int8"),
     lambda c: c.validate_model_sharding(1001, 2)),
], ids=lambda c: c[0])
def test_validate_model_sharding_refusals_are_the_references(case):
    match, kw, call = case
    got, want = _both(call, **kw)
    assert match in got and got == want


def test_validate_model_sharding_accepts_compatible_lossy():
    d = get_codec("int8").qblock * 4
    FLConfig(**_kw(compression="int8")).validate_model_sharding(
        d, 2, leaf_sizes=(d // 2, d // 2))


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_comm_stats_model_shards_is_the_references(codec):
    c, jc = FLConfig(**_kw(compression=codec)), \
        JaxFLConfig(**_kw(compression=codec))
    for d in (1000, 1001, 4096):
        for ms in (1, 2, 3, 4):
            assert comm_stats(c, d, model_shards=ms) == \
                jax_comm_stats(jc, d, model_shards=ms), (d, ms)
    assert comm_stats(c, 1000) == comm_stats(c, 1000, model_shards=1)


def test_resolve_update_dtype_errors_are_the_references():
    for args, jargs in ((("int8",), ("int8",)),
                        (("bf16", torch.float32), ("bf16", jnp.float32))):
        with pytest.raises(ValueError) as e:
            resolve_update_dtype(*args)
        with pytest.raises(ValueError) as je:
            jax_resolve(*jargs)
        assert str(e.value) == str(je.value)
    assert resolve_update_dtype("f32") == torch.float32
    assert resolve_update_dtype("bf16") == torch.bfloat16
    assert resolve_update_dtype("f32", torch.bfloat16) == torch.bfloat16
    # no process group (or gloo): the reference's CPU gate, fp32
    assert update_psum_dtype(torch.bfloat16) == torch.float32


# ----------------------------------------------------------------------
# launch/shapes
# ----------------------------------------------------------------------

def test_shape_registry():
    assert SHAPES["train_4k"].seq == 4096 and SHAPES["train_4k"].batch == 256
    assert SHAPES["prefill_32k"].seq == 32768 \
        and SHAPES["prefill_32k"].batch == 32
    assert SHAPES["decode_32k"].batch == 128
    assert SHAPES["long_500k"].seq == 524288 \
        and SHAPES["long_500k"].batch == 1
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JAX_SHAPES.items()}


def test_long_context_applicability():
    long = SHAPES["long_500k"]
    capable = {a for a in configs.all_arch_ids()
               if applicable(configs.get(a), long)}
    assert capable == {"h2o-danube-1-8b", "jamba-v0-1-52b",
                       "falcon-mamba-7b"}
    assert capable == {a for a in jconfigs.all_arch_ids()
                       if jconfigs.get(a).sub_quadratic}
    for a in configs.all_arch_ids():
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert applicable(configs.get(a), SHAPES[s])


class _Mesh:
    """The two attributes the shape helpers read from a DeviceMesh."""
    mesh_dim_names = ("data", "model")
    shape = (4, 2)


def test_train_and_serve_inputs_are_meta_with_placements():
    m = _Mesh()
    s, pl = sds((3, 5), torch.int32)
    assert s.device.type == "meta" and s.shape == (3, 5) and pl is None
    cfg = configs.get("whisper-medium", smoke=True)
    specs, pls = train_inputs(cfg, InputShape("t", "train", 64, 8), m)
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (8, 64), "guide_tokens": (4, 1, 64), "byz_kind": (4,),
        "rng": (2,), "enc_emb": (8, cfg.enc_seq, cfg.d_model),
        "guide_enc_emb": (4, 1, cfg.enc_seq, cfg.d_model)}
    assert all(v.device.type == "meta" for v in specs.values())
    assert pls["tokens"] == (m, (("data",), None))
    assert pls["rng"] == (m, ())
    cfg = configs.get("jamba-v0.1-52b", smoke=True)
    specs, pls = serve_inputs(cfg, InputShape("d", "decode", 64, 8), m)
    assert specs["token"].shape == (8, 1) and pls["token"][1] == (("data",),
                                                                  None)
    ssm = [v for k, v in _flat(pls["cache"]) if k.endswith("ssm")]
    assert ssm and all(p[1][-2:] == ("model", None) for p in ssm)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flat(v, f"{prefix}/{k}")]
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and isinstance(tree[0], dict)):
        return [kv for i, v in enumerate(tree)
                for kv in _flat(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_sharded_param_specs_pair_meta_params_with_the_table():
    m = _Mesh()
    specs = sharded_param_specs(configs.get("gemma-2b", smoke=True), m)
    pairs = [v for _, v in _flat(specs)]
    assert pairs and all(t.device.type == "meta" and pl[0] is m
                         for t, pl in pairs)
    assert any("model" in pl[1] for _, pl in pairs)


# ----------------------------------------------------------------------
# off-mesh identities and named refusals
# ----------------------------------------------------------------------

def test_helpers_are_the_identity_off_mesh():
    x = torch.arange(24.0).reshape(4, 6)
    assert sharding.get_mesh() is None
    for fn in (sharding.shard_clients, sharding.client_put,
               sharding.shard_flat, sharding.shard_updates,
               sharding.shard_lanes):
        assert fn(x) is x
    assert sharding.shard(x, (None, "model")) is x
    assert sharding.sweep_put({"a": x})["a"] is x
    assert sharding.put_clients_by_shard(
        lambda lo, hi: x[lo:hi], (4, 6)).shape == (4, 6)
    assert (sharding.data_shard_count(), sharding.pod_count(),
            sharding.model_shard_count()) == (1, 1, 1)
    assert sharding.pod_data_counts() == (1, 1)
    assert sharding.client_spec(2) is None and sharding.lane_spec(3) is None
    assert sharding.update_spec(2) is None
    assert sharding.param_shardings({"a": x}) is None
    p = {"wq": x}
    assert sharding.place_params(p) is p and sharding.shard_params(p) is p
    with sharding.use_mesh("m"):
        assert sharding.get_mesh() == "m"
    assert sharding.get_mesh() is None


def test_mesh_constructors_need_a_process_group():
    for make in (tmesh.make_host_mesh, tmesh.make_host_pod_mesh,
                 tmesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="init_local_group"):
            make(device="cpu")
    with pytest.raises(ValueError, match="store_path"):
        tmesh.init_local_group(0, 1)


def test_shard_mismatch_error_is_one_class():
    assert sharding.ShardMismatchError is chunking.ShardMismatchError
    with pytest.raises(sharding.ShardMismatchError):
        chunking.resolve_pods(3, 4)


def test_serve_functions_take_the_references_mesh():
    for fn in (serve.make_serve_step, serve.make_prefill,
               serve.make_forward):
        ps = inspect.signature(fn).parameters
        assert list(ps)[:2] == ["cfg", "mesh"] and ps["mesh"].default is None
    assert inspect.signature(serve.make_serve_step).parameters[
        "donate_cache"].default is True


def test_train_cli_runs_on_the_cpu_when_asked():
    """``python -m repro_torch.launch.train --device cpu`` joins a one-rank
    gloo group of its own, runs the engine on a 1 x 1 mesh and prints its
    eval rounds."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma-2b", "--rounds", "2", "--seq", "16", "--batch", "4",
         "--eval-every", "1", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr[-4000:]
    assert "on mesh {'data': 1, 'model': 1} (1 clients)" in p.stdout
    assert "round   1 acc=" in p.stdout and "round   2 acc=" in p.stdout
