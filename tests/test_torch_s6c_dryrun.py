"""``repro_torch.launch.dryrun``: a step traced under ``FakeTensorMode`` on
a fake process group, with the reference's record.

* A tiny dense config's prefill: ``cost["flops"]`` equals a hand count of
  its matmuls (2·m·n·k each), exactly; ``argument_size_in_bytes`` the
  params' and the tokens' bytes, exactly; the op census's ``dot`` count
  too.
* A tiny round step on a fake 2 x 2 mesh: the collectives of the record
  equal the hand count of ``tests/test_torch_s6c_hlo.py``.
* Every (arch, shape)'s ``ok``/``skip`` equals the reference's
  ``launch.shapes.applicable``, a skip with the reference's reason.
* The twin of ``tests/test_sharded_step.py::test_dryrun_entrypoint_smoke``:
  ``python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape
  decode_32k --mesh pod --device cpu`` in a subprocess: rc 0, ``[ok  ]``,
  every key of the record in its ``--out`` JSON.
* No process group survives a call, whether it traces, skips or raises;
  ``use_kernels=True`` is refused by name.
* The decode step the dry run traces takes its position as a 0-d tensor,
  which no host read reaches: its logits and cache equal, bit for bit,
  the step's at the same position as a Python int, for a sliding-window
  ring that wraps, MoE and cross attention.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_leaves

from repro import configs as jconfigs
from repro.launch.shapes import SHAPES as JSHAPES
from repro.launch.shapes import applicable as japplicable
from repro_torch import configs, models
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import make_prefill
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.train import make_fl_round_step
from repro_torch.models import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "status", "opt", "cost",
               "memory", "collectives", "collective_bytes", "roofline",
               "ops", "trace_s"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_prefill_flops(cfg, B, S):
    """2·m·n·k of every matmul of a dense prefill with the direct
    attention path, and the head at the last position only."""
    T, D, F = B * S, cfg.d_model, cfg.d_ff
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * T * D * H * dh            # wq
             + 2 * 2 * T * D * K * dh      # wk, wv
             + 2 * T * H * dh * D          # wo
             + 3 * 2 * T * D * F           # w_gate, w_up, w_down
             + 2 * 2 * B * H * S * S * dh)  # q·kᵀ and p·v
    return cfg.n_layers * layer + 2 * B * D * cfg.padded_vocab


def test_tiny_prefill_flops_and_arguments_are_exact():
    B, S = 2, 8
    with dryrun.fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        with FakeTensorMode():
            params = dryrun.fake_tree(models.init(None, TINY, "meta"), "cpu")
            tok = torch.empty((B, S), dtype=torch.int32)
            rec = dryrun.trace(make_prefill(TINY, mesh), params, tok)
    assert not dist.is_initialized()
    assert rec["cost"]["flops"] == _tiny_prefill_flops(TINY, B, S)
    want_args = sum(p.numel() * p.element_size() for p in
                    dryrun._tensors(models.init(None, TINY, "meta"))) \
        + B * S * 4
    assert rec["memory"]["argument_size_in_bytes"] == want_args
    # logits (B, 1, Vp) fp32 and the cache: K and V of every layer
    cache = TINY.n_layers * 2 * B * S * TINY.n_kv_heads * TINY.head_dim * 2
    assert rec["memory"]["output_size_in_bytes"] == \
        B * TINY.padded_vocab * 4 + cache
    assert rec["memory"]["temp_size_in_bytes"] >= \
        rec["memory"]["output_size_in_bytes"]
    # 7 projections a layer, 2 attention einsums a layer, the head
    assert rec["ops"]["dot"] == TINY.n_layers * 9 + 1
    assert rec["ops"]["custom-call"] == 0 and rec["ops"]["fusion"] == 0
    assert rec["collective_bytes"] == 0.0
    assert rec["roofline"]["flops"] == rec["cost"]["flops"]


def test_tiny_round_step_collectives_on_a_fake_mesh():
    """The census of a round step on a fake 2 x 2 group: one all-reduce a
    leaf plus the loss and the kept count, fp32; the mask and criteria
    gathered (the gloo run's count in test_torch_s6c_hlo.py)."""
    cfg = dataclasses.replace(TINY, dtype="float32", param_dtype="float32")
    S = 8
    with dryrun.fake_group(4):
        mesh = make_host_mesh(2, 2, device="cpu")
        with FakeTensorMode():
            meta = models.init(None, cfg, "meta")
            params = dryrun.fake_tree(meta, "cpu")
            inputs = {"tokens": torch.empty((4, S), dtype=torch.int32),
                      "guide_tokens": torch.empty((2, 1, S),
                                                  dtype=torch.int32),
                      "byz_kind": torch.empty((2,), dtype=torch.int32),
                      "rng": torch.empty((2,), dtype=torch.int64)}
            step = make_fl_round_step(cfg, mesh, donate=False)
            rec = dryrun.trace(step, params, inputs)
    leaves = dryrun._tensors(meta)
    want = 4 + 4 + sum(4 * p.numel() for p in leaves)
    assert rec["collectives"]["all-reduce"]["count"] == 2 + len(leaves)
    assert rec["collectives"]["all-reduce"]["result_bytes"] == want
    assert rec["collectives"]["all-gather"]["count"] == 3
    assert rec["ops"]["all-reduce"] == 2 + len(leaves)
    assert rec["collective_bytes"] == 2.0 * want + 2 * (1 + 4 + 4)
    # params and inputs, whole on the rank
    assert rec["memory"]["argument_size_in_bytes"] == \
        sum(4 * p.numel() for p in leaves) + 4 * 4 * S + 2 * S * 4 + 8 + 16
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_ok_and_skip_follow_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name, shape in SHAPES.items():
        ok = japplicable(jcfg, JSHAPES[name])
        assert dryrun.applicable(cfg, shape) == ok, (arch, name)
        if not ok:
            rec = dryrun.dryrun_one(arch, name, False, verbose=False,
                                    device="cpu")
            assert rec["status"] == "skip"
            assert rec["reason"] == dryrun.SKIP_REASON
            assert not dist.is_initialized()


def test_dryrun_entrypoint_smoke(tmp_path):
    out = tmp_path / "dryrun.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "h2o-danube-1.8b", "--shape", "decode_32k", "--mesh", "pod",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert p.returncode == 0, p.stderr[-4000:]
    assert "[ok  ]" in p.stdout
    assert "dry-run: 1 ok, 0 documented skips, 0 errors" in p.stdout
    (rec,) = json.loads(out.read_text())
    assert set(rec) == RECORD_KEYS
    assert (rec["status"], rec["mesh"], rec["kind"]) == \
        ("ok", "16x16", "decode")
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    # this rank's tiles (1/16 of most leaves) and its KV cache
    assert rec["memory"]["argument_size_in_bytes"] > 3e9
    assert rec["cost"]["flops"] > 0 and rec["roofline"]["dominant"] in \
        ("compute", "memory", "collective")


def test_no_group_survives_and_kernels_are_refused(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("inside the fake group")
    monkeypatch.setattr(dryrun, "_step", boom)
    with pytest.raises(RuntimeError, match="inside the fake group"):
        dryrun.dryrun_one("gemma-2b", "decode_32k", True, verbose=False,
                          device="cpu")
    assert not dist.is_initialized()
    get = configs.get
    monkeypatch.setattr(dryrun.configs, "get", lambda a: dataclasses.replace(
        get(a), use_kernels=True))
    with pytest.raises(ValueError, match="use_kernels=True"):
        dryrun.dryrun_one("gemma-2b", "decode_32k", False, verbose=False,
                          device="cpu")
    assert not dist.is_initialized()
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k",
                        "--mesh", "pod", "--device", "cpu"]) == 1
    assert not dist.is_initialized()
    # a live group is never stacked on
    with dryrun.fake_group(1):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_group(2):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-moe-16b",
                                  "whisper-medium"])
def test_decode_at_a_tensor_position_is_the_int_position(arch):
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype="float32", param_dtype="float32")
    T = 20           # past h2o-danube's window of 16: the ring wraps
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, T),
                         generator=torch.Generator().manual_seed(1))
    at_int = models.init_cache(cfg, 2, T, "cpu")
    at_tensor = models.init_cache(cfg, 2, T, "cpu")
    with torch.inference_mode():
        for t in range(T):
            want, at_int = models.decode_step(params, cfg, toks[:, t:t + 1],
                                              at_int, t)
            got, at_tensor = models.decode_step(
                params, cfg, toks[:, t:t + 1], at_tensor,
                torch.tensor(t, dtype=torch.int32))
            assert torch.equal(got, want), t
    for a, b in zip(tree_leaves(at_tensor), tree_leaves(at_int)):
        assert torch.equal(a, b)
