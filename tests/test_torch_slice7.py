"""The redesigned fp32 flash-attention and median/trimmed-mean kernels, on
the CPU: what their designs rest on, held without the card.

* The median/trimmed-mean kernel's sorting network (``network_pairs``, the
  comparators ``csrc/robust_agg.cu`` builds at compile time) sorts every
  0/1 column up to 16 values (by the 0-1 principle, every column) and
  random and tied columns of 17 to 64 values, each padded with +inf to its
  bucket; the pads stay at the end.
* The kernel's trimmed mean without a second sort: the narrowest window of
  N - 2f sorted values around the median gives exactly the reference's
  threshold (the (N - 2f)-th smallest distance), and the run of sorted
  values within it gives ``ref.trimmed_ref``'s result; the median, read
  off the middle, equals ``ref.median_ref`` bit for bit.
* The fp32 flash kernel's launch plan (``fp32_plan``: head-dim bucket,
  16- or 4-byte copies, key splits; the q-tile order and the split
  chunks), as pure functions of the shapes, strides and addresses, and
  an emulation of the kernel's schedule in PyTorch (64-row q tiles, four
  16-row warps that skip fully masked key tiles and mask only edge tiles,
  the online softmax in log2 units, key splits combined in order) against
  the JAX reference.
* Both wrappers and their pre-redesign entry points refuse by name what
  they refused before, before any build.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    FP32_BUCKETS, FP32_KEY_TILE, FP32_Q_TILE, MAX_SPLITS, MIN_SPLIT_TILES,
    NEG_INF, flash_attention_cuda, flash_attention_plain,
    flash_attention_simt_v1_cuda, fp32_block_item, fp32_key_tiles,
    fp32_plan, fp32_split_range)
from repro_torch.kernels.robust_agg import (MAX_CLIENTS, SORT_BUCKETS,
                                            network_pairs, robust_agg_cuda,
                                            robust_agg_v1_cuda, sort_bucket)

CSRC = Path(_build.CSRC)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the median/trimmed-mean kernel's sorting network
# ----------------------------------------------------------------------

def apply_network(cols, n):
    """Run the kernel's network for n values on the rows of ``cols``
    (M, n) float32, padded with +inf to the bucket: -> (M, bucket)."""
    p = sort_bucket(n)
    s = np.full((cols.shape[0], p), np.inf, dtype=np.float32)
    s[:, :n] = cols
    for a, b in network_pairs(p):
        lo = np.minimum(s[:, a], s[:, b])
        s[:, b] = np.maximum(s[:, a], s[:, b])
        s[:, a] = lo
    return s


def test_network_matches_the_kernel_source():
    """The mirror's comparator count at 64 is the source's kMaxPairs, and
    its buckets are the ones the source dispatches."""
    src = (CSRC / "robust_agg.cu").read_text()
    assert int(re.search(r"kMaxPairs = (\d+);", src).group(1)) == \
        len(network_pairs(64))
    assert tuple(sorted({int(b) for b in
                         re.findall(r"launch<(\d+)>\(uu", src)})) == \
        SORT_BUCKETS
    assert sort_bucket(23) == 24 and len(network_pairs(24)) == 132
    assert len(network_pairs(32)) == 191


@pytest.mark.parametrize("n", range(1, 17))
def test_network_sorts_every_01_column(n):
    """0-1 principle: a comparator network that sorts every 0/1 input
    sorts every input.  All 2^n columns of n values, padded."""
    bits = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1)
    s = apply_network(bits.astype(np.float32), n)
    np.testing.assert_array_equal(s[:, :n], np.sort(bits, axis=1))
    assert np.isinf(s[:, n:]).all()


@pytest.mark.parametrize("n", range(17, MAX_CLIENTS + 1))
def test_network_sorts_random_and_tied_columns(n):
    rng = np.random.default_rng(n)
    cols = np.concatenate([
        rng.normal(size=(500, n)),
        rng.integers(-3, 4, size=(500, n)) * 0.5,        # exact ties
        np.repeat(rng.normal(size=(20, 1)), n, axis=1),  # constant columns
    ]).astype(np.float32)
    s = apply_network(cols, n)
    np.testing.assert_array_equal(s[:, :n], np.sort(cols, axis=1))
    assert np.isinf(s[:, n:]).all()


# ----------------------------------------------------------------------
# the trimmed mean off the sorted column
# ----------------------------------------------------------------------

def window_form(u, f):
    """The kernel's arithmetic in float32 numpy on (N, D) u: the sorted
    column, the median off its middle, the threshold as the narrowest
    window of keep_n values around it, the admitted run summed in sorted
    order -> (median, threshold, trimmed mean)."""
    n = u.shape[0]
    keep = max(n - 2 * f, 1)
    s = np.sort(u, axis=0)
    h = n // 2
    m = s[h] if n % 2 else np.float32(0.5) * (s[h - 1] + s[h])
    t = np.min([np.maximum(m - s[a], s[a + keep - 1] - m)
                for a in range(n - keep + 1)], axis=0)
    admit = np.abs(s - m) <= t
    total = np.where(admit, s, np.float32(0)).sum(0, dtype=np.float32)
    trim = total / np.maximum(admit.sum(0), 1).astype(np.float32)
    return m, t, trim


@pytest.mark.parametrize("n", range(1, MAX_CLIENTS + 1))
def test_window_threshold_is_the_references(n):
    """For every f with N - 2f >= 1: the window threshold equals the
    reference's sorted-distance threshold exactly, the admitted run gives
    ``trimmed_ref`` within 1e-5 * max|u| + 1e-7 (the same values, summed
    in another order), and the median equals ``median_ref`` bitwise; on
    random columns and on columns with exact ties."""
    rng = np.random.default_rng(100 + n)
    for u in (rng.normal(size=(n, 96)).astype(np.float32),
              (rng.integers(-3, 4, size=(n, 96)) * 0.5).astype(np.float32)):
        med = np.asarray(jax_ref.median_ref(jnp.asarray(u)))
        bar = 1e-5 * np.abs(u).max(0) + 1e-7
        for f in range((n - 1) // 2 + 1):
            m, t, trim = window_form(u, f)
            np.testing.assert_array_equal(m, med)
            want_t = np.sort(np.abs(u - med), axis=0)[max(n - 2 * f, 1) - 1]
            np.testing.assert_array_equal(t, want_t)
            ref = np.asarray(jax_ref.trimmed_ref(jnp.asarray(u), f))
            assert (np.abs(trim - ref) <= bar).all(), (n, f)


# ----------------------------------------------------------------------
# the fp32 flash kernel's launch plan
# ----------------------------------------------------------------------

def _contig_strides(B, H, S, dh):
    return [H * S * dh, S * dh, dh]


def _plan(B, H, K, Sq, Sk, dh, window=None, n_sm=132, q_strides=None,
          addresses=(0, 0, 0)):
    strides = ((q_strides or _contig_strides(B, H, Sq, dh))
               + 2 * _contig_strides(B, K, Sk, dh))
    return fp32_plan(B, H, Sq, Sk, dh, window, strides, addresses, n_sm)


@pytest.mark.parametrize("dh", range(1, 257))
def test_fp32_bucket_is_the_smallest_that_holds_dh(dh):
    b = _plan(1, 2, 1, 100, 100, dh).bucket
    assert b in FP32_BUCKETS and dh <= b
    assert all(c < dh for c in FP32_BUCKETS if c < b)


@pytest.mark.parametrize("dh,addresses,q_strides,want", [
    (80, (0, 0, 0), None, 16),
    (72, (1024, 2048, 4096), None, 16),
    (33, (0, 0, 0), None, 4),                 # dh % 4
    (64, (4, 0, 0), None, 4),                 # q off 16 bytes
    (64, (0, 0, 8), None, 4),                 # v off 16 bytes
    (64, (0, 0, 0), [64 * 70, 70, 65], 4),    # a sequence stride of 65
    (64, (0, 0, 0), [64 * 4 * 8, 64, 4 * 64], 16),   # the model's view
])
def test_fp32_copy_width_follows_dh_alignment_and_strides(dh, addresses,
                                                          q_strides, want):
    plan = _plan(1, 4, 4, 8, 8, dh, q_strides=q_strides,
                 addresses=addresses)
    assert plan.copy_bytes == want


def test_fp32_splits_fill_a_small_grid_only():
    # kernel_bench's shape: 128 blocks against 3 x 132 slots, split for
    # one and a half waves
    kb = _plan(1, 8, 8, 1024, 1024, 128)
    assert (kb.bucket, kb.n_qt, kb.splits, kb.blocks) == (128, 16, 5, 640)
    # h2o-danube's prefill and minitron-8b's heads fill the card unsplit
    assert _plan(2, 32, 8, 8192, 8192, 80, 4096).splits == 1
    assert _plan(1, 32, 8, 4096, 4096, 128).splits == 1
    # one block an SM at dh = 256: 16 blocks split 8 ways, no further
    assert _plan(1, 1, 1, 1000, 1000, 256).splits == MAX_SPLITS
    # too few key tiles to split: a chunk keeps MIN_SPLIT_TILES
    assert _plan(1, 1, 1, 40, 40, 64).splits == 1
    small = _plan(1, 2, 1, 700, 700, 33, 300)
    first, last = fp32_key_tiles(small.n_qt - 1, 700, 700, 300)
    assert small.splits > 1
    assert (last - first + 1) // small.splits >= MIN_SPLIT_TILES
    # more SMs, fewer splits; never more than MAX_SPLITS
    for n_sm in (1, 16, 66, 132, 264, 10_000):
        p = _plan(1, 8, 8, 1024, 1024, 128, n_sm=n_sm)
        assert 1 <= p.splits <= MAX_SPLITS


@pytest.mark.parametrize("n,splits", [(n, s) for n in (1, 2, 3, 7, 32, 129)
                                      for s in range(1, MAX_SPLITS + 1)])
def test_fp32_split_chunks_tile_the_key_range_once(n, splits):
    first = 5
    chunks = [fp32_split_range(first, first + n - 1, s, splits)
              for s in range(splits)]
    assert chunks[0][0] == first and chunks[-1][1] == first + n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [hi - lo for lo, hi in chunks]
    assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n_qt,heads,splits", [(16, 8, 4), (5, 3, 1),
                                               (1, 64, 8), (7, 1, 3)])
def test_fp32_blocks_run_the_heaviest_q_tile_first(n_qt, heads, splits):
    items = [fp32_block_item(b, n_qt, heads, splits)
             for b in range(n_qt * heads * splits)]
    assert sorted(items) == [(t, h, s) for t in range(n_qt)
                             for h in range(heads) for s in range(splits)]
    tiles = [t for t, _, _ in items]
    assert tiles == sorted(tiles, reverse=True)
    # the splits of one (q tile, head) are neighbours
    assert all(items[i][:2] == items[i + splits - 1][:2]
               for i in range(0, len(items), splits))


@pytest.mark.parametrize("Sq,Sk,window", [(300, 300, None), (300, 300, 70),
                                          (130, 50, None), (50, 130, 1),
                                          (257, 257, 32), (64, 64, 200)])
def test_fp32_key_tiles_hold_every_admitted_key(Sq, Sk, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    for qt in range(-(-Sq // FP32_Q_TILE)):
        first, last = fp32_key_tiles(qt, Sq, Sk, window)
        rows = mask[qt * FP32_Q_TILE:(qt + 1) * FP32_Q_TILE]
        keys = np.flatnonzero(rows.any(0))
        assert keys.min() >= first * FP32_KEY_TILE
        assert keys.max() < (last + 1) * FP32_KEY_TILE


# ----------------------------------------------------------------------
# the fp32 flash kernel's schedule, emulated
# ----------------------------------------------------------------------

LOG2E = 1.4426950408889634


def emulate_fp32_kernel(q, k, v, window, softcap, splits):
    """flash_fwd_kernel and flash_combine_kernel's arithmetic in float32
    torch: each q tile's key tiles cut into ``splits`` chunks; per chunk
    four 16-row warps, each skipping a key tile when its ``active`` test
    fails and masking only when its ``edge`` test holds (the kernel's own
    expressions); scores and m in log2 units; the chunks combined in
    order."""
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(dh)
    c = 1.0 if softcap else scale * LOG2E
    wr, kt = FP32_Q_TILE // 4, FP32_KEY_TILE
    out = torch.empty_like(q)
    kpad = torch.zeros((B, K, Sk + kt, dh))
    vpad = torch.zeros((B, K, Sk + kt, dh))
    kpad[:, :, :Sk], vpad[:, :, :Sk] = k, v
    for b in range(B):
        for h in range(H):
            for qt in range(-(-Sq // FP32_Q_TILE)):
                first, last = fp32_key_tiles(qt, Sq, Sk, window)
                for w in range(4):
                    row0 = qt * FP32_Q_TILE + wr * w
                    row_last = min(row0 + wr, Sq) - 1
                    if row0 > row_last:
                        continue
                    rows = torch.arange(row0, row0 + wr)[:, None]
                    qw = torch.zeros((wr, dh))
                    qw[:row_last - row0 + 1] = q[b, h, row0:row_last + 1]
                    parts = []
                    for s in range(splits):
                        lo, hi = fp32_split_range(first, last, s, splits)
                        m = torch.full((wr,), NEG_INF)
                        l = torch.zeros(wr)
                        o = torch.zeros((wr, dh))
                        for t in range(lo, hi):
                            k0 = t * kt
                            active = k0 <= row_last and (
                                not window or k0 + kt - 1 > row0 - window)
                            if not active:
                                continue
                            edge = (k0 + kt - 1 > row0 or k0 + kt > Sk
                                    or (window and k0 <= row_last - window))
                            kk = kpad[b, h // g, k0:k0 + kt]
                            x = qw @ kk.T
                            if softcap:
                                x = torch.tanh(x * (scale / softcap)) * (
                                    softcap * LOG2E)
                            if edge:
                                keys = torch.arange(k0, k0 + kt)[None, :]
                                keep = (keys <= rows) & (keys < Sk)
                                if window:
                                    keep &= keys > rows - window
                                x = torch.where(keep, x, NEG_INF)
                            m_new = torch.maximum(m, x.max(1).values)
                            alpha = torch.exp2((m - m_new) * c)
                            p = torch.exp2(x * c - (m_new * c)[:, None])
                            l = l * alpha + p.sum(1)
                            o = o * alpha[:, None] + p @ vpad[b, h // g,
                                                               k0:k0 + kt]
                            m = m_new
                        parts.append((m, l, o))
                    mt = torch.stack([m for m, _, _ in parts]).max(0).values
                    ws = [torch.exp2((m - mt) * c) for m, _, _ in parts]
                    lt = sum(wt * l for wt, (_, l, _) in zip(ws, parts))
                    ot = sum(wt[:, None] * o for wt, (_, _, o) in
                             zip(ws, parts))
                    res = ot / torch.clamp(lt, min=1e-30)[:, None]
                    out[b, h, row0:row_last + 1] = res[:row_last - row0 + 1]
    return out


@pytest.mark.parametrize("B,H,K,Sq,Sk,dh,window,softcap,splits", [
    (1, 2, 1, 300, 300, 16, None, None, 1),
    (1, 2, 1, 300, 300, 16, None, None, 3),
    (1, 2, 2, 333, 333, 20, 70, None, 1),
    (1, 2, 2, 333, 333, 20, 70, None, 4),
    (1, 4, 2, 200, 200, 8, 1, None, 2),
    (1, 2, 1, 257, 257, 12, None, 30.0, 5),
    (1, 2, 1, 130, 50, 8, None, None, 2),
    (1, 2, 1, 50, 130, 8, 20, 20.0, 1),
    (2, 2, 1, 100, 100, 8, 150, None, 8),
])
def test_fp32_kernel_schedule_matches_the_reference(B, H, K, Sq, Sk, dh,
                                                    window, softcap, splits):
    """The kernel's tiling, warp skips, edge-only masks, log2-unit online
    softmax and ordered split combine give the reference's attention
    within the card's fp32 bar (1e-4)."""
    rng = np.random.default_rng(Sq + dh)
    q = (rng.normal(size=(B, H, Sq, dh)) * (3.0 if softcap else 1.0)
         ).astype(np.float32)
    k = rng.normal(size=(B, K, Sk, dh)).astype(np.float32)
    v = rng.normal(size=(B, K, Sk, dh)).astype(np.float32)
    got = emulate_fp32_kernel(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window, softcap, splits)
    want = np.asarray(jax_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        softcap=softcap))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    plain = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window, softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)


# ----------------------------------------------------------------------
# the wrappers' refusals
# ----------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel must not be built")
    monkeypatch.setattr(_build, "entry_point", refuse)


@pytest.mark.parametrize("fn", [robust_agg_cuda, robust_agg_v1_cuda])
@pytest.mark.parametrize("u,exc,match", [
    (torch.zeros(16), ValueError, r"must be \(N, D\)"),
    (torch.zeros((MAX_CLIENTS + 1, 16)), ValueError,
     "1 to 64 clients, got N = 65"),
    (torch.zeros((0, 16)), ValueError, "1 to 64 clients, got N = 0"),
    (torch.zeros((23, 16)), ValueError, "must be a CUDA tensor"),
])
def test_robust_wrappers_refuse_by_name(no_build, fn, u, exc, match):
    launches = robust_agg_cuda.launches
    with pytest.raises(exc, match=match):
        fn(u, 5)
    assert robust_agg_cuda.launches == launches


@pytest.mark.parametrize("fn", [flash_attention_cuda,
                                flash_attention_simt_v1_cuda])
@pytest.mark.parametrize("shapes,kw,exc,match", [
    (((1, 2, 8, 16), (1, 1, 8, 16)), {}, ValueError, "CUDA tensor"),
    (((1, 2, 8, 16), (1, 3, 8, 16)), {}, ValueError, "do not divide"),
    (((2, 8, 16), (1, 1, 8, 16)), {}, ValueError, "must be 4-D"),
    (((1, 2, 8, 257), (1, 1, 8, 257)), {}, ValueError,
     "head dim 257 outside"),
    (((1, 2, 8, 16), (1, 1, 8, 16)), {"window": 0}, ValueError,
     "window must be >= 1"),
])
def test_flash_wrappers_refuse_by_name(no_build, fn, shapes, kw, exc, match):
    qs, ks = shapes
    launches = flash_attention_cuda.launches
    with pytest.raises(exc, match=match):
        fn(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks), **kw)
    assert flash_attention_cuda.launches == launches


@pytest.mark.parametrize("fn", [flash_attention_cuda,
                                flash_attention_simt_v1_cuda])
def test_flash_wrappers_refuse_other_dtypes(no_build, fn):
    x = torch.zeros((1, 2, 8, 16), dtype=torch.float16)
    with pytest.raises(TypeError, match="fp32 or bf16 only"):
        fn(x, x[:, :1], x[:, :1])
