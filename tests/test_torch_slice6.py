"""The redesigned similarity and dequant-fold kernels, the split bf16 p·v
and the serve step's tokens, on the CPU: what they rest on, held without
the card.

* The similarity kernel's segment plan (``kernels/similarity.py``): for
  every D and row alignment the segments tile [0, D) exactly once, float4
  segments start on the row's 16-byte boundary, and a row's plan is the
  same whatever N (a streamed block of 8 rows and the dense matrix give a
  row the same plan, so the kernel reduces it in the same order).
* The bf16 flash kernel's arithmetic, emulated in PyTorch: p split into
  bf16(p) and bf16(p - bf16(p)) for p·v meets one bf16 step of the JAX
  reference (atol 1e-5, rtol 2^-7), and one bf16 rounding of p, the
  kernel's arithmetic before the split, does not.
* ``make_serve_step`` returns int32 tokens equal to the reference's.
* The dequant-fold wrapper refuses wrong dtypes, shapes and devices by
  name, before any build.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.kernels import ref as jax_ref
from repro.launch import serve as jserve
from repro_torch import configs, models
from repro_torch.convert import tree_from_jax
from repro_torch.kernels.dequant_fold import dequant_fold_update_cuda
from repro_torch.kernels.similarity import (ALIGN_OFFSETS, MAX_CLUSTER,
                                            SEG_VEC, cluster_size,
                                            plan_table, row_plan)
from repro_torch.launch.serve import make_serve_step
from test_torch_zoo_kernels import _bf16_kernel_rounding


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the similarity kernel's segment plan
# ----------------------------------------------------------------------

SEG = 4 * SEG_VEC                     # elements of a whole float4 segment
PLAN_DS = (list(range(1, 18))
           + [SEG + k for k in range(-6, 7)]
           + [2 * SEG + k for k in range(-3, 4)]
           + [5 * SEG + 3, 7850, 16_411, 199_210, 2_000_000, 28_146_762])


def segments(d, plan):
    """The element range [lo, hi) of each segment of a row under ``plan``,
    as the kernel walks it: segment s covers float4s [SEG_VEC·s,
    SEG_VEC·(s + 1)) from the row's head; segment 0 also takes the head,
    the last also the tail."""
    bounds = [plan.head + 4 * min(SEG_VEC * s, plan.nvec)
              for s in range(plan.nseg + 1)]
    bounds[0], bounds[-1] = 0, d
    return list(zip(bounds[:-1], bounds[1:]))


@pytest.mark.parametrize("offset", ALIGN_OFFSETS)
@pytest.mark.parametrize("d", PLAN_DS)
def test_similarity_segments_tile_the_row_once(d, offset):
    """Segments are contiguous, non-empty and cover [0, D) once; the head
    brings the row to its 16-byte boundary, and every segment but the
    last holds a whole SEG_VEC of float4s from there."""
    plan = row_plan(d, offset)
    segs = segments(d, plan)
    assert len(segs) == plan.nseg >= 1
    assert segs[0][0] == 0 and segs[-1][1] == d
    assert all(lo < hi for lo, hi in segs)
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert plan.nvec * 4 <= d - plan.head < plan.nvec * 4 + 4
    if plan.head < d:
        assert (offset + 4 * plan.head) % 16 == 0
    for s, (lo, hi) in enumerate(segs[:-1]):
        assert hi == plan.head + 4 * SEG_VEC * (s + 1)
    # the kernel's own rule for the count (it refuses any other)
    assert plan.nseg == max(1, -(-plan.nvec // SEG_VEC))
    # the cluster's blocks take segments c, c + C, ...: every segment once
    c = cluster_size(d)
    assert 1 <= c <= min(MAX_CLUSTER, max(p.nseg for p in plan_table(d)))
    walked = sorted(s for b in range(c) for s in range(b, plan.nseg, c))
    assert walked == list(range(plan.nseg))


def _row_plans(t):
    """The plan the kernel takes for each row of a contiguous (N, D) fp32
    tensor: the wrapper's table, indexed by the row's address mod 16."""
    n, d = t.shape
    table = plan_table(d)
    return [table[(t.data_ptr() + 4 * r * d) % 16 // 4] for r in range(n)]


@pytest.mark.parametrize("d", [7850, SEG + 2, 16_386, 199_210])
def test_similarity_row_plan_does_not_depend_on_n(d):
    """Rows 0-7 of a 23-row matrix and a fresh 8-row copy of them get the
    same plans, as do the rows of 1-, 8- and 64-row matrices: a row's plan
    is a function of D and its alignment only.  D = 2 mod 4 alternates two
    alignments between neighbouring rows."""
    z = torch.zeros((23, d))
    plans = _row_plans(z)
    assert _row_plans(z[:8].clone()) == plans[:8]
    assert _row_plans(z[8:16].clone()) == plans[8:16]
    for n in (1, 8, 64):
        assert _row_plans(torch.zeros((n, d))) == \
            [plans[r % 4] for r in range(n)]
    if d % 4 == 2:
        assert plans[0] != plans[1] and plans[0] == plans[2]
    # the alignments' segment counts differ by at most one, and the
    # cluster size is D's alone
    counts = [p.nseg for p in plan_table(d)]
    assert max(counts) - min(counts) <= 1
    assert cluster_size(d) == min(MAX_CLUSTER, max(counts))


def test_similarity_plan_refuses_an_offset_off_the_float_grid():
    with pytest.raises(ValueError, match="offset must be one of"):
        row_plan(100, 2)


# ----------------------------------------------------------------------
# the bf16 flash kernel's split p·v against the JAX reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 30.0])
def test_split_pv_meets_one_bf16_step_of_the_reference(softcap):
    """B 1, H 4 / K 2, S 96, dh 32, window 40: the emulated kernel with
    the split p·v lies within atol 1e-5 / rtol 2^-7 of
    ``repro.kernels.ref.flash_attention_ref``; one bf16 rounding of p
    lies farther from it and misses that bar."""
    rng = np.random.default_rng(16)
    qscale = 6.0 if softcap else 1.0
    q = (rng.normal(size=(1, 4, 96, 32)) * qscale).astype(np.float32)
    k = rng.normal(size=(1, 2, 96, 32)).astype(np.float32)
    v = rng.normal(size=(1, 2, 96, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    # the same bf16 values into the reference
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = torch.from_numpy(np.asarray(
        jax_ref.flash_attention_ref(jq, jk, jv, window=40, softcap=softcap)
    ).astype(np.float32))
    bar = 1e-5 + 2.0 ** -7 * want.abs()
    split = _bf16_kernel_rounding(tq, tk, tv, 40, softcap).float()
    single = _bf16_kernel_rounding(tq, tk, tv, 40, softcap,
                                   split=False).float()
    err_split = (split - want).abs()
    err_single = (single - want).abs()
    assert bool((err_split <= bar).all()), (err_split / bar).max().item()
    assert err_single.max().item() > err_split.max().item()
    assert not bool((err_single <= bar).all())


# ----------------------------------------------------------------------
# make_serve_step's tokens
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "falcon-mamba-7b"])
def test_serve_step_returns_int32_tokens_as_the_reference(arch):
    """Greedy steps at a SMOKE config in fp32, each step fed the last
    step's token: the port's next tokens are int32 (B, 1), as the
    reference's, and equal them."""
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), **kw)
    cfg = dataclasses.replace(configs.get(arch, smoke=True), **kw)
    jp = jmodels.init(jax.random.PRNGKey(6), jcfg)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    first = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32)
    jstep = jserve.make_serve_step(jcfg, None, donate_cache=False)
    step = make_serve_step(cfg)
    jcache = jmodels.init_cache(jcfg, 2, 8)
    cache = models.init_cache(cfg, 2, 8, "cpu")
    jtok, tok = jnp.asarray(first), torch.from_numpy(first)
    for t in range(7):
        jtok, jcache = jstep(jp, jtok, jcache, jnp.int32(t))
        tok, cache = step(tp, tok, cache, t)
        assert tok.dtype == torch.int32 and tuple(tok.shape) == (2, 1)
        assert np.asarray(jtok).dtype == np.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


# ----------------------------------------------------------------------
# the dequant-fold wrapper's refusals
# ----------------------------------------------------------------------

def _fold_args(n=2, d=130, qblock=128):
    nb = -(-d // qblock)
    return (torch.zeros((n, d), dtype=torch.int8), torch.ones((n, nb)),
            torch.ones(n), torch.zeros(d))


@pytest.mark.parametrize("which,bad,exc,match", [
    (0, torch.zeros((2, 130), dtype=torch.int32), TypeError,
     "q must be torch.int8"),
    (1, torch.ones((2, 2), dtype=torch.float64), TypeError,
     "scale must be torch.float32"),
    (2, torch.ones(2, dtype=torch.bfloat16), TypeError,
     "w must be torch.float32"),
    (3, torch.zeros(130, dtype=torch.float16), TypeError,
     "acc must be torch.float32"),
    (0, torch.zeros((2, 13, 10), dtype=torch.int8), ValueError,
     r"q must be \(n, D\)"),
    (1, torch.ones((2, 3)), ValueError, r"scale must be \(2, 2\)"),
    (2, torch.ones(3), ValueError, r"w must be \(2,\)"),
    (3, torch.zeros(129), ValueError, r"acc must be \(130,\)"),
    (1, torch.ones((2, 2), device="meta"), ValueError, "scale must be"),
    (0, torch.zeros((2, 130), dtype=torch.int8), ValueError,
     "q must be a CUDA tensor"),
])
def test_dequant_fold_wrapper_refuses_by_name(which, bad, exc, match):
    """Every operand is checked before any build or launch, and the
    refusal names it: dtype, shape, device (a CPU or mismatched tensor)."""
    args = list(_fold_args())
    args[which] = bad
    with pytest.raises(exc, match=match):
        dequant_fold_update_cuda(*args, 128)
    with pytest.raises(ValueError, match="qblock must be >= 1"):
        dequant_fold_update_cuda(*_fold_args(), 0)
    assert dequant_fold_update_cuda.launches == 0
