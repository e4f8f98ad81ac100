"""``repro_torch.launch.hlo``: the reference's HLO analysis (collective
bytes, op census, roofline terms), read from the port's trace records.

* ``collective_stats``/``total_collective_bytes`` and ``op_census`` on
  hand-made records, exactly.
* ``roofline_terms`` against hand arithmetic at the H100's data-sheet
  figures (relative 1e-12).
* One ``launch.train.make_fl_round_step`` on a 2 x 2 gloo mesh (4 ranks,
  ``launch.mesh.spawn_local``): the all-reduces ``sharding.
  record_collectives`` records equal a hand count from the params' leaves,
  exactly, and their count equals the ``collective_counts()`` delta.
* ``record_collectives`` blocks nest, on a fake 2-rank group.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.convert import flatten_tree
from repro_torch.launch import hlo
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.launch.train import make_fl_round_step

RANK_TIMEOUT = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RECORDS = [
    {"kind": "all-reduce", "dtype": torch.float32, "shape": (10,),
     "group_size": 4},
    {"kind": "all-reduce", "dtype": torch.bfloat16, "shape": (3, 5),
     "group_size": 2},
    {"kind": "all-gather", "dtype": torch.uint8, "shape": (1,),
     "group_size": 8},
    {"kind": "all-gather", "dtype": torch.float32, "shape": (2, 3),
     "group_size": 4},
]


def test_collective_stats_on_hand_made_records():
    s = hlo.collective_stats(RECORDS)
    assert set(s) == set(hlo.COLLECTIVES)
    # all-reduce: the input's bytes, moved twice
    assert s["all-reduce"] == {"count": 2, "result_bytes": 40 + 30,
                               "moved_bytes": 140.0}
    # all-gather: the group's stack of inputs, moved once
    assert s["all-gather"] == {"count": 2, "result_bytes": 8 + 96,
                               "moved_bytes": 104.0}
    for k in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert s[k] == {"count": 0, "result_bytes": 0, "moved_bytes": 0.0}
    assert hlo.total_collective_bytes(RECORDS) == 244.0
    assert hlo.total_collective_bytes([]) == 0.0


def test_op_census_families():
    ops = {"mm": 3, "bmm": 2, "addmm": 1, "matmul": 4, "index_put_": 2,
           "scatter_add_": 1, "index": 5, "embedding": 1, "gather": 2,
           "convolution": 7, "add": 9, "view": 11,
           "similarity_stats": 2, "flash_attention": 3,
           "all-reduce": 6, "all-gather": 3}
    c = hlo.op_census(ops)
    assert c == {"fusion": 0, "custom-call": 5, "dot": 10,
                 "convolution": 7, "scatter": 3, "gather": 8,
                 "all-reduce": 6, "all-gather": 3, "reduce-scatter": 0,
                 "all-to-all": 0, "collective-permute": 0}
    assert all(v == 0 for v in hlo.op_census({}).values())


def test_roofline_terms_at_the_h100_figures():
    assert (hlo.PEAK_FLOPS_BF16, hlo.HBM_BW) == (989e12, 3.35e12)
    assert hlo.NVLINK_BW_PER_LINK * hlo.NVLINK_LINKS == 450e9
    assert not hasattr(hlo, "ICI_BW_PER_LINK")
    r = hlo.roofline_terms({"flops": 2 * 989e12, "bytes accessed": 3.35e12},
                           450e9 * 3)
    want = {"t_compute": 2.0, "t_memory": 1.0, "t_collective": 3.0}
    for k, v in want.items():
        assert r[k] == pytest.approx(v, rel=1e-12), k
    assert r["dominant"] == "collective"
    assert (r["flops"], r["bytes"], r["collective_bytes"]) == \
        (2 * 989e12, 3.35e12, 450e9 * 3)
    assert hlo.roofline_terms({"flops": 1e12}, 0.0)["dominant"] == "compute"
    assert hlo.roofline_terms({}, 0.0)["t_memory"] == 0.0


def _cfg():
    return dataclasses.replace(configs.get("gemma-2b", smoke=True),
                               dtype="float32", param_dtype="float32")


def _round_step_rank(rank, world):
    """A 2 x 2 mesh's round step, its collectives recorded."""
    torch.manual_seed(0)
    cfg = _cfg()
    mesh = make_host_mesh(2, 2, device="cpu")
    params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(3)
    S = 8
    inputs = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, S),
                                                dtype=np.int32)),
        "guide_tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 1, S), dtype=np.int32)),
        "byz_kind": torch.tensor([0, 1], dtype=torch.int32),
        "rng": torch.zeros((2,), dtype=torch.int64)}
    step = make_fl_round_step(cfg, mesh, lr=0.1, donate=False)
    before = sharding.collective_counts()
    with sharding.record_collectives() as recs:
        step(params, inputs)
    after = sharding.collective_counts()
    return {"records": recs,
            "delta": {k: after[k] - before[k] for k in after},
            "leaves": [tuple(v.shape) for v in flatten_tree(params).values()]}


def test_round_step_collectives_equal_a_hand_count(tmp_path):
    outs = spawn_local(_round_step_rank, 4, timeout=RANK_TIMEOUT,
                       workdir=str(tmp_path))
    for out in outs:
        recs, leaves = out["records"], out["leaves"]
        # the clients' mean loss, the kept count, one psum a leaf (fp32
        # under gloo); the mask and the two criteria gathered
        want_ar = 4 + 4 + sum(4 * int(np.prod(s)) for s in leaves)
        stats = hlo.collective_stats(recs)
        assert stats["all-reduce"]["count"] == 2 + len(leaves)
        assert stats["all-reduce"]["result_bytes"] == want_ar
        assert stats["all-reduce"]["moved_bytes"] == 2.0 * want_ar
        assert all(r["dtype"] == torch.float32 and r["group_size"] == 2
                   for r in recs if r["kind"] == "all-reduce")
        # uint8 mask, fp32 C1 and C2: one value a client, 2 clients
        assert stats["all-gather"]["count"] == 3
        assert stats["all-gather"]["result_bytes"] == 2 * (1 + 4 + 4)
        assert out["delta"] == {"all_reduce": stats["all-reduce"]["count"],
                                "all_gather": stats["all-gather"]["count"]}
    assert len({str(o["records"]) for o in outs}) == 1


def test_record_collectives_nests():
    """Nested blocks: the inner sees its own calls, the outer all of them,
    and the counters count every call as before."""
    from repro_torch.launch.dryrun import fake_group
    with fake_group(2):
        before = sharding.collective_counts()
        with sharding.record_collectives() as outer:
            sharding.all_reduce(torch.ones(3), None)
            with sharding.record_collectives() as inner:
                sharding.all_gather(torch.zeros(2, dtype=torch.bool), None)
            sharding.all_reduce(torch.ones((), dtype=torch.bfloat16), None)
        sharding.all_reduce(torch.ones(1), None)
        after = sharding.collective_counts()
    assert inner == [{"kind": "all-gather", "dtype": torch.uint8,
                      "shape": (2,), "group_size": 2}]
    assert [r["kind"] for r in outer] == ["all-reduce", "all-gather",
                                         "all-reduce"]
    assert hlo.collective_stats(outer)["all-reduce"]["result_bytes"] == 14
    assert {k: after[k] - before[k] for k in after} == \
        {"all_reduce": 3, "all_gather": 1}
    assert sharding.api._RECORDS == []
