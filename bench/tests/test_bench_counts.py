"""bench/counts against counts made by hand."""
import pytest

from bench.counts import flops, kernels
from bench.harness import spec

DANUBE = spec.load_json(spec.ROOT / "bench/configs/h2o-danube-1.8b-fl.json")
MLP3 = spec.load_json(spec.ROOT / "bench/configs/mlp3-fl.json")


def test_danube_params():
    # 24 layers of 69,468,160 matmul weights plus the 2,560 x 32,000 head;
    # the params add the 32,000 x 2,560 embedding (the published config
    # does not tie it to the head) and 49 norms of 2,560
    assert flops.decoder_layer_weights(DANUBE) == 69_468_160
    assert flops.decoder_matmul_weights(DANUBE) == 1_749_155_840
    shapes = spec.family("decoder").param_shapes(DANUBE)
    assert kernels.flat_dim(shapes) == 1_749_155_840 + 81_920_000 + 49 * 2560
    assert kernels.flat_dim(shapes) == 1_831_201_280


def test_mlp3_params():
    assert flops.mlp3_weights(MLP3) == 198_800
    assert kernels.flat_dim(spec.family("mlp3").param_shapes(MLP3)) == 199_210


def test_mlp3_round_flops():
    t = spec.load_json(spec.ROOT / "bench/traffic/xdevice-1024.json")
    # 1,024 clients x (10 + 1 enclave) examples x 6 x 198,800, plus the
    # eval's 800 x 2 x 198,800 over 10 rounds
    want = 1024 * 11 * 6 * 198_800 + 800 * 2 * 198_800 / 10
    assert flops.mlp3_round(MLP3, t) == pytest.approx(want, rel=1e-12)


def test_attention_pairs():
    assert flops.attention_pairs(513) == 513 * 514 // 2
    assert flops.attention_pairs(10, window=4) == 4 * 5 // 2 + 6 * 4


@pytest.mark.parametrize("kernel,shape,bound_us", [
    ("similarity_stats", (1024, 7850), 19.200),
    ("similarity_stats", (23, 199_210), 10.94),
    ("masked_aggregate", (1024, 7850), 9.608),
    ("masked_aggregate", (23, 199_210), 5.709),
    ("masked_agg_update", (23, 199_210), 5.947),
    ("masked_agg_update", (1, 100_369_280), 359.53),
    ("dequant_fold_update", (8, 199_210), 0.966),
    ("dequant_fold_update", (64, 199_210), 4.401),
    ("dequant_fold_update", (23, 2_000_000), 18.94),
    ("dequant_fold_update", (1, 179_907_840), 485.01),
])
def test_kernel_bounds_match_the_kernel_table(kernel, shape, bound_us):
    b, ops = kernels.BYTES_OPS[kernel](*shape)
    assert kernels.least_s(b, ops) * 1e6 == pytest.approx(bound_us, abs=6e-3)


def test_calls_per_round():
    dense = {"n_clients": 1024, "streaming": False, "client_chunk": 64}
    assert kernels.calls(dense, 5) == {"similarity_stats": [(1024, 5)],
                                       "masked_aggregate": [(1024, 5)]}
    stream = {"n_clients": 8, "streaming": True, "client_chunk": 3}
    c = kernels.calls(stream, 5)
    assert c["masked_agg_update"] == [(3, 5), (3, 5), (2, 5)]
    assert kernels.round_least_s("masked_aggregate", stream, 5) == 0
    # the int8 stream folds its blocks with the dequantize-and-fold kernel
    c8 = kernels.calls(dict(stream, compression="int8"), 5)
    assert c8 == {"similarity_stats": [(3, 5), (3, 5), (2, 5)],
                  "dequant_fold_update": [(3, 5), (3, 5), (2, 5)]}
    assert kernels.round_least_s("masked_agg_update",
                                 dict(stream, compression="int8"), 5) == 0


def test_dequant_fold_bytes():
    # one streamed block of mlp3-xdevice-int8: 64 rows of int8 codes, 1,557
    # fp32 scales a row, 64 weights, the accumulator read and written
    b, ops = kernels.dequant_fold_update(64, 199_210)
    assert b == 64 * 199_210 + 64 * 1557 * 4 + 64 * 4 + 2 * 199_210 * 4
    assert ops == 3 * 64 * 199_210
