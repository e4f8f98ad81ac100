"""The port's compressed uplink against the JAX reference, on the CPU.

* The codecs: the port's ``encode`` against ``repro.fl.compression``'s on
  identical fp32 inputs, bitwise for the int8 payload, its scales and the
  bf16 payload, including values exactly at k + 0.5 after the division,
  an all-zero block and a ragged tail; ``wire_bytes``,
  ``encode_with_feedback`` and the per-leaf ``quantize_tree``.
* The kernels' plain versions: the int8 decode and the dequantize-and-fold
  against ``repro.kernels.ref`` and the interpret-mode Pallas op, and the
  weighted fold of a bf16 payload against the interpret-mode
  ``masked_agg_update``.  The CUDA kernels run only on the card
  (``chip_smoke.py`` holds them against these plain versions there).
* ``comm_stats`` and the ``FLConfig`` knobs of streaming and compression.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import compression as jcomp
from repro.fl.metrics import comm_stats as jax_comm_stats
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.fl import FLConfig
from repro_torch.fl import compression as comp
from repro_torch.fl.metrics import comm_stats
from repro_torch.kernels import ops
from repro_torch.kernels.dequant_fold import (dequant_fold_update_cuda,
                                              dequant_fold_update_plain,
                                              dequant_int8)
from repro_torch.kernels.masked_agg import masked_agg_update_plain


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _rows(n, d, seed=0):
    """Rows whose magnitudes span many decades, so blocks of every scale
    occur; block 0 holds values at k + 0.5 after the division (absmax
    127 makes the scale exactly 1), block 1 is all zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d))
         * 10.0 ** rng.uniform(-6, 3, size=(n, 1))).astype(np.float32)
    if d >= 256:
        x[:, :128] = np.arange(128, dtype=np.float32) - 63.5
        x[:, 0] = 127.0
        x[:, 128:256] = 0.0
    return x


# ragged tails (d % 128 = 74, 10, 58, 1), a single block, the 3-NN's D
WIDTHS = [(23, 13002), (5, 1290), (3, 7850), (2, 129), (1, 100),
          (4, 199210)]


@pytest.mark.parametrize("n,d", WIDTHS)
def test_int8_encode_is_bitwise_the_reference(n, d):
    x = _rows(n, d, seed=d)
    enc = comp.INT8.encode(torch.from_numpy(x))
    jenc = jcomp.INT8.encode(jnp.asarray(x))
    assert enc["q"].dtype == torch.int8 and enc["q"].shape == (n, d)
    assert enc["scale"].shape == (n, -(-d // comp.QBLOCK))
    np.testing.assert_array_equal(enc["q"].numpy(), np.asarray(jenc["q"]))
    np.testing.assert_array_equal(_bits(enc["scale"].numpy()),
                                  _bits(jenc["scale"]))
    if d >= 256:
        # k + 0.5 rounds half to even in both; an all-zero block is 0
        half = np.round(np.arange(128, dtype=np.float32) - 63.5)
        half[0] = 127
        np.testing.assert_array_equal(enc["q"][0, :128].numpy(), half)
        assert not enc["q"][:, 128:256].any() and \
            not enc["scale"][:, 1].any()
    dec = comp.INT8.decode(enc)
    np.testing.assert_array_equal(
        _bits(dec.numpy()), _bits(jcomp.INT8.decode(jenc)))


@pytest.mark.parametrize("n,d", WIDTHS[:3])
def test_int8_encode_is_the_ieee_float32_oracle(n, d):
    """The same quantization in numpy float32 (IEEE division): the port
    is held to it as well as to the reference."""
    x = _rows(n, d, seed=7)
    nb = -(-d // 128)
    xb = np.pad(x, ((0, 0), (0, nb * 128 - d))).reshape(n, nb, 128)
    scale = np.abs(xb).max(-1) / np.float32(127.0)
    q = np.clip(np.round(xb / np.maximum(scale, np.float32(1e-30))[..., None]),
                -127, 127).astype(np.int8).reshape(n, -1)[:, :d]
    enc = comp.INT8.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(enc["q"].numpy(), q)
    np.testing.assert_array_equal(_bits(enc["scale"].numpy()), _bits(scale))


@pytest.mark.parametrize("n,d", WIDTHS[:3])
def test_bf16_and_f32_codecs_are_bitwise_the_reference(n, d):
    x = _rows(n, d, seed=3)
    # a tie of bf16 rounding (round to even) at 1 + 2^-8
    x[0, -1] = np.float32(1.0 + 2.0 ** -8)
    q = comp.BF16.encode(torch.from_numpy(x))["q"]
    jq = jcomp.BF16.encode(jnp.asarray(x))["q"]
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(q.to(torch.float32).numpy()),
        _bits(np.asarray(jq.astype(jnp.float32))))
    assert q[0, -1].item() == 1.0
    np.testing.assert_array_equal(
        _bits(comp.BF16.decode({"q": q}).numpy()),
        _bits(jcomp.BF16.decode({"q": jq})))
    f = comp.F32.encode(torch.from_numpy(x))
    assert torch.equal(comp.F32.decode(f), torch.from_numpy(x))


@pytest.mark.parametrize("d", [7850, 13002, 199210])
def test_wire_bytes_match_the_reference(d):
    for name in ("f32", "bf16", "int8"):
        assert comp.wire_bytes(comp.get_codec(name), d) == \
            jcomp.wire_bytes(jcomp.get_codec(name), d), name
    assert comp.wire_bytes(comp.INT8, d) == d + 4 * (-(-d // 128))


def test_codec_registry():
    assert comp.available_codecs() == jcomp.available_codecs() == \
        ("f32", "bf16", "int8")
    assert comp.F32.lossless and not comp.BF16.lossless
    assert comp.BF16.wire_dtype == torch.bfloat16 and comp.BF16.qblock is None
    assert comp.INT8.qblock == comp.QBLOCK == jcomp.QBLOCK
    with pytest.raises(ValueError, match="unknown compression codec"):
        comp.get_codec("fp8")
    with pytest.raises(ValueError, match="already registered"):
        comp.register_codec(comp.INT8)


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_encode_with_feedback_matches_the_reference(name):
    rng = np.random.default_rng(4)
    u = rng.normal(size=(6, 1001)).astype(np.float32)
    r = (0.01 * rng.normal(size=(6, 1001))).astype(np.float32)
    enc, dec, res = comp.encode_with_feedback(
        comp.get_codec(name), torch.from_numpy(u), torch.from_numpy(r))
    jenc, jdec, jres = jcomp.encode_with_feedback(
        jcomp.get_codec(name), jnp.asarray(u), jnp.asarray(r))
    for key in enc:
        np.testing.assert_array_equal(
            enc[key].to(torch.float32).numpy(),
            np.asarray(jenc[key].astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(dec.numpy()), _bits(jdec))
    np.testing.assert_array_equal(_bits(res.numpy()), _bits(jres))
    # the residual is exactly what the wire lost
    assert torch.equal(res, torch.from_numpy(u + r) - dec)


def test_quantize_tree_quantizes_each_leaf_on_its_own():
    """Per leaf: a (C, 784, 16) weight is quantized in 128-wide blocks
    along its own flattened 12,544 columns, not along the whole flat D."""
    rng = np.random.default_rng(5)
    tree = {"w1": rng.normal(size=(3, 784, 16)).astype(np.float32),
            "b1": (1e-3 * rng.normal(size=(3, 16))).astype(np.float32),
            "w3": rng.normal(size=(3, 16, 10)).astype(np.float32)}
    for name in ("bf16", "int8"):
        got = comp.quantize_tree(comp.get_codec(name),
                                 {k: torch.from_numpy(v)
                                  for k, v in tree.items()})
        want = jcomp.quantize_tree(jcomp.get_codec(name),
                                   {k: jnp.asarray(v)
                                    for k, v in tree.items()})
        for k in tree:
            assert got[k].shape == tree[k].shape
            np.testing.assert_array_equal(_bits(got[k].numpy()),
                                          _bits(want[k]), err_msg=k)
    # the tiny bias keeps its own scale: flattened with w1 it would round
    # to zero
    b = comp.quantize_tree(comp.INT8, {"b1": torch.from_numpy(tree["b1"])})
    assert b["b1"].abs().min() > 0
    assert comp.quantize_tree(comp.F32, tree) is tree


# ----------------------------------------------------------------------
# the kernels' plain versions
# ----------------------------------------------------------------------

def _payload(n, d, seed=0):
    x = _rows(n, d, seed)
    enc = jcomp.INT8.encode(jnp.asarray(x))
    return np.array(enc["q"]), np.array(enc["scale"])


@pytest.mark.parametrize("n,d", [(8, 13002), (7, 1290), (23, 7850),
                                 (1, 100)])
def test_dequant_int8_is_bitwise_the_reference_decoder(n, d):
    q, s = _payload(n, d)
    got = dequant_int8(torch.from_numpy(q), torch.from_numpy(s), 128)
    assert got.is_contiguous() and got.shape == (n, d)
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(jax_ref.dequant_int8_ref(jnp.asarray(q), jnp.asarray(s), 128)))
    with pytest.raises(ValueError, match="blocks"):
        dequant_int8(torch.from_numpy(q), torch.from_numpy(s[:, 1:]), 128)


@pytest.mark.parametrize("weights", ["real", "binary", "zero"])
@pytest.mark.parametrize("n,d,qblock", [(8, 13002, 128), (7, 1290, 128),
                                        (23, 7850, 128), (5, 1000, 64)])
def test_dequant_fold_plain_matches_the_reference(n, d, qblock, weights):
    rng = np.random.default_rng(n + d)
    x = _rows(n, d, seed=1)
    enc = jcomp._int8_encode(jnp.asarray(x), qblock)
    q, s = np.array(enc["q"]), np.array(enc["scale"])
    w = {"real": rng.random(n) * 2.0,
         "binary": (rng.random(n) > 0.4) * 1.0,
         "zero": np.zeros(n)}[weights].astype(np.float32)
    acc = rng.normal(size=d).astype(np.float32)
    got = dequant_fold_update_plain(*(torch.from_numpy(a)
                                      for a in (q, s, w, acc)), qblock)
    ref = jax_ref.dequant_fold_ref(*(jnp.asarray(a) for a in (q, s, w, acc)),
                                   qblock)
    kern = jax_ops.dequant_fold_update(*(jnp.asarray(a)
                                         for a in (q, s, w, acc)),
                                       qblock=qblock)
    for want in (ref, kern):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(x).max()))
    if weights == "zero":
        assert torch.equal(got, torch.from_numpy(acc))
    # the route: a CPU tensor goes to the plain version
    assert torch.equal(ops.dequant_fold_update(
        *(torch.from_numpy(a) for a in (q, s, w, acc)), qblock), got)


def test_dequant_fold_plain_is_bitwise_the_oracle_where_the_sum_is_exact():
    """Integer payloads, power-of-two scales and 0/1 weights make every
    product and sum exact, so any association gives the same bits."""
    rng = np.random.default_rng(8)
    n, d = 8, 1290
    q = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    s = (2.0 ** rng.integers(-6, 3, size=(n, -(-d // 128)))).astype(np.float32)
    w = (rng.random(n) > 0.5).astype(np.float32)
    acc = rng.integers(-50, 50, size=d).astype(np.float32)
    got = dequant_fold_update_plain(*(torch.from_numpy(a)
                                      for a in (q, s, w, acc)), 128)
    ref = jax_ref.dequant_fold_ref(*(jnp.asarray(a) for a in (q, s, w, acc)),
                                   128)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("n,d", [(8, 13002), (23, 7850)])
def test_bf16_weighted_fold_plain_matches_the_interpret_mode_kernel(n, d):
    rng = np.random.default_rng(9)
    x = _rows(n, d, seed=2)
    u = torch.from_numpy(x).to(torch.bfloat16)
    w = (rng.random(n) * 2.0).astype(np.float32)
    acc = rng.normal(size=d).astype(np.float32)
    got = masked_agg_update_plain(u, torch.from_numpy(w),
                                  torch.from_numpy(acc))
    ju = jnp.asarray(x).astype(jnp.bfloat16)
    kern = jax_ops.masked_agg_update(ju, jnp.asarray(w), jnp.asarray(acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).max()))
    # the bf16 fold is the fold of the exact fp32 widening
    assert torch.equal(got, masked_agg_update_plain(
        u.to(torch.float32), torch.from_numpy(w), torch.from_numpy(acc)))
    assert torch.equal(ops.masked_agg_update(u, torch.from_numpy(w),
                                             torch.from_numpy(acc)), got)


def test_dequant_fold_cuda_refuses_cpu_tensors_before_building():
    q = torch.zeros((2, 130), dtype=torch.int8)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        dequant_fold_update_cuda(q, torch.ones(2, 2), torch.ones(2),
                                 torch.zeros(130), 128)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.dequant_fold_update(q.to("meta"), torch.ones(2, 2),
                                torch.ones(2), torch.zeros(130), 128)
    assert dequant_fold_update_cuda.launches == 0


# ----------------------------------------------------------------------
# comm_stats and the FLConfig knobs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [7850, 199210])
def test_comm_stats_match_the_reference(name, d):
    from repro.fl import FLConfig as JaxFLConfig
    got = comm_stats(FLConfig(compression=name, participation=0.5), d)
    want = jax_comm_stats(JaxFLConfig(compression=name, participation=0.5),
                          d)
    assert got == want
    assert got["uplink_bytes_per_round"] == 12 * got[
        "uplink_bytes_per_client"]


def test_flconfig_validates_streaming_and_compression():
    with pytest.raises(ValueError, match="client_chunk must be None or a "
                                         "positive int"):
        FLConfig(client_chunk=0)
    with pytest.raises(ValueError, match="client_chunk must be"):
        FLConfig(client_chunk=True)
    with pytest.raises(ValueError, match="stream_shards must be"):
        FLConfig(stream_shards=-1)
    with pytest.raises(ValueError, match="requires streaming=True"):
        FLConfig(pods=2, client_chunk=4)
    with pytest.raises(ValueError, match="requires client_chunk"):
        FLConfig(pods=2, streaming=True)
    with pytest.raises(ValueError, match="cannot tile the padded block "
                                         "count 3"):
        FLConfig(pods=2, streaming=True, client_chunk=8)
    with pytest.raises(ValueError, match="not a registered codec"):
        FLConfig(compression="fp8")
    cfg = FLConfig(pods=2, streaming=True, client_chunk=6,
                   compression="int8")
    assert cfg.pods == 2 and cfg.compression == "int8"
