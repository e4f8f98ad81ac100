#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of the repo, one CUDA card

Phases (any failure raises and the script exits non-zero):

  1. device  - the card's name and power limit (nvidia-smi), torch/CUDA;
               TF32 off for matmuls and cuDNN convolutions, so every
               comparison on the card is in full fp32
  2. build   - nvcc builds the CUDA kernels from src/repro_torch/kernels/csrc
  3. kernels - slice 1: the similarity and masked-mean kernels against
               their plain PyTorch versions at (23, 7850), (23, 199210),
               (1024, 7850), (23, 16411) and the small CNN's and VGG-11's
               widths (23, 117706), (23, 28146762), with bool, fp32 and
               all-false masks; bitwise repeatability; CUDA-event timings
               of kernel, plain version and one PyTorch library call, with
               inputs cold (read from HBM, as the byte bound assumes) and
               warm (L2-resident where they fit).  Slice 2: the weighted
               fold at those shapes, and the median/trimmed-mean kernel at
               (23, 7850), (23, 199210), (24, 7850), (64, 7850),
               (23, 28146762) with f in {0, 5} and exact ties, timed likewise
  4. train   - slice 1: the paper's configuration (softmax regression, 23
               clients, f = 5, 60 rounds): diversefl/oracle under sign_flip
               and diversefl/mean under gaussian, with the reference's
               accuracy and detection bars and the kernels' launch counts;
               then the card's rounds against the CPU's on injected draws
  5. slice 2 - Fig. 4 on the 3-NN at D = 199,210 (the 4 x 3 grid of rules
               and attacks, 40 rounds, the reference's label-flip bar, the
               other baselines once each, launch counts), Fig. 5's small
               CNN, two VGG-11 rounds of diversefl and fltrust at
               D = 28,146,762, and fltrust/median rounds on the card
               against the CPU's on injected draws
  6. slice 3 - [kernels]: the int8 codec on the card against the CPU's,
               bitwise; the dequantize-and-fold kernel and the weighted
               fold of a bf16 payload against their plain versions from
               (8, 199210) to VGG-11's (8, 28146762), timed cold and warm.
               [stream]: Fig. 4's 3-NN streamed in blocks of 8 under the
               f32, bf16 and int8 codecs: streaming against dense bitwise,
               40-round runs with the reference's bars and launch counts.
               [comm]: the reference's compressed-uplink deployment (256
               clients, blocks of 64) on the 3-NN per codec.  [vgg11]:
               streaming int8 diversefl rounds.  [train]: streaming int8
               rounds on the card against the CPU's on injected draws
  7. result  - a ``kernels`` JSON line, then ``{"ok": true, ...}`` last
"""
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.attacks import AttackConfig  # noqa: E402
from repro_torch.core.diversefl import masked_sum_fold  # noqa: E402
from repro_torch.data import (FederatedData, make_cifar_like,  # noqa: E402
                              make_mnist_like, partition_sorted_shards)
from repro_torch.fl import (FLConfig, Federation,  # noqa: E402
                            make_round_body, mlp3, run_federated_training,
                            small_cnn, softmax_regression, vgg11)
from repro_torch.fl.compression import get_codec  # noqa: E402
from repro_torch.fl.server import (AggregationContext,  # noqa: E402
                                   aggregate)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.dequant_fold import (  # noqa: E402
    dequant_fold_update_cuda, dequant_fold_update_plain, dequant_int8)
from repro_torch.kernels.masked_agg import (masked_agg_cuda,  # noqa: E402
                                            masked_agg_plain,
                                            masked_agg_update_cuda,
                                            masked_agg_update_plain)
from repro_torch.kernels.robust_agg import (robust_agg_cuda,  # noqa: E402
                                            robust_agg_plain)
from repro_torch.kernels.similarity import (similarity_cuda,  # noqa: E402
                                            similarity_plain)
from repro_torch.optim import inv_sqrt_lr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2
COLD_BYTES = 4 * L2_BYTES        # a cold timing cycles over this many bytes
MAIN_SHAPE = (23, 7850)          # 23 clients x softmax regression's D
SEED = 0                         # the training runs' draws (see detection_scan)
QBLOCK = 128                     # the int8 codec's scale block
# the update widths of the models the slices train: the 3-NN (784-200-
# 200-10), the Appendix-C small CNN and VGG-11
D_MLP3, D_SMALL_CNN, D_VGG11 = 199_210, 117_706, 28_146_762
SHAPES = [MAIN_SHAPE, (23, D_MLP3), (1024, 7850), (23, 16411),
          (23, D_SMALL_CNN), (23, D_VGG11)]
KERNEL_META = {
    "similarity_stats": {
        "source": "src/repro_torch/kernels/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity.py:44"},
    "masked_aggregate": {
        "source": "src/repro_torch/kernels/csrc/masked_agg.cu",
        "replaces": "src/repro/kernels/masked_agg.py:84"},
    "masked_agg_update": {
        "source": "src/repro_torch/kernels/csrc/masked_agg.cu",
        "replaces": "src/repro/kernels/masked_agg.py:47"},
    "robust_aggregate": {
        "source": "src/repro_torch/kernels/csrc/robust_agg.cu",
        "replaces": "src/repro/kernels/robust_agg.py:55"},
    "dequant_fold_update": {
        "source": "src/repro_torch/kernels/csrc/dequant_fold.cu",
        "replaces": "src/repro/kernels/dequant_fold.py:40"},
}
S2_SHAPE = (23, D_MLP3)          # the weighted fold's shape in Fig. 4
ROBUST_SHAPES = [(23, 7850), S2_SHAPE, (24, 7850), (64, 7850), (23, D_VGG11)]
F_BUDGET = 5                     # f of the paper's 23-client runs
FIG4_SCHEMES = ("oracle", "diversefl", "median", "fltrust")
FIG4_ATTACKS = ("gaussian", "sign_flip", "label_flip")
OTHER_BASELINES = ("trimmed_mean", "krum", "bulyan", "resampling")
DEV = "cuda"                     # slice 3's phases place everything here
CODECS = ("f32", "bf16", "int8")
CHUNK = 8                        # the headline's client_chunk: 3 blocks
S3_SHAPE = (CHUNK, D_MLP3)       # one int8 block of the 3-NN's clients
S3_SHAPES = [S3_SHAPE, (23, D_MLP3), (64, D_MLP3), (23, 16411),
             (23, 2_000_000), (CHUNK, D_VGG11)]


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, sets, iters=200, warmup=20):
    """(device ms, host-inclusive ms) per call; call i is
    ``fn(*sets[i % len(sets)])``.

    Device: CUDA events around ``iters`` calls enqueued while a sleep
    kernel holds the stream, so the calls run back to back on the card
    and the Python wrapper's host time is hidden.  Host-inclusive: wall
    clock per call of a synchronised loop, what one call costs an eager
    round.  With one input set the inputs stay in L2 where they fit
    (warm); with :func:`cold_sets` every call reads them from HBM."""
    k = len(sets)
    for i in range(warmup):
        fn(*sets[i % k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(*sets[i % k])
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * host_s * iters + 1e-3)))
    start.record()
    for i in range(iters):
        fn(*sets[i % k])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host_s * 1e3


def cold_sets(*tensors):
    """Copies of ``tensors``, enough that cycling through them touches
    COLD_BYTES (4x the L2) between two uses of one copy: each call then
    reads its inputs from HBM, the memory the byte bound assumes."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    k = max(1, math.ceil(COLD_BYTES / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(k - 1)]


def time_kernel(card, name, shape, fns, inputs, bound, err, iters=200,
                warmup=20):
    """Device times of a kernel, its plain version and the library call,
    ``fns``, each called on ``inputs``: warm (one input set, L2-resident
    where it fits) and cold (cycling over :func:`cold_sets`).  The cold
    readings pair with the HBM ``bound`` and go into the JSON line."""
    warm, cold = [inputs], cold_sets(*inputs)
    (ms, host), (p_ms, p_host), (l_ms, _) = (
        cuda_ms(f, cold, iters, warmup) for f in fns)
    w_ms, w_p, w_l = (cuda_ms(f, warm, iters, warmup)[0] for f in fns)
    del cold
    log(f"[kernels] {name} {shape}: device kernel {ms * 1e3:.2f} us cold "
        f"/ {w_ms * 1e3:.2f} us warm, plain {p_ms * 1e3:.2f} / "
        f"{w_p * 1e3:.2f} us, library {l_ms * 1e3:.2f} / {w_l * 1e3:.2f} "
        f"us, bound {bound[0] * 1e3:.3f} us ({bound[1]}, HBM); per call "
        f"with host kernel {host * 1e3:.2f} us, plain {p_host * 1e3:.2f} "
        f"us; max |err| {err:.3g} [{card}]")
    return dict(ms=ms, plain_ms=p_ms, library_ms=l_ms, bound=bound,
                max_abs_err=err, warm_ms=w_ms)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] nvcc for sm_90a: {time.perf_counter() - t0:.2f} s total")
    for name, b in built.items():
        log(f"[build] {name}: {b.path.name} ({b.seconds:.2f} s)")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def check_similarity(z, g):
    out = similarity_cuda(z, g)
    again = similarity_cuda(z, g)
    torch.cuda.synchronize()
    ref = similarity_plain(z, g)
    scale = torch.stack([(z * g).abs().sum(1), (z * z).sum(1),
                         (g * g).sum(1)], dim=1)
    err = (out - ref).abs()
    if not bool((err <= 1e-4 * scale).all()):
        raise AssertionError(f"similarity_stats disagrees at {tuple(z.shape)}:"
                             f" max |err| {err.max().item()}")
    if not torch.equal(out, again):
        raise AssertionError(f"similarity_stats not bitwise repeatable at "
                             f"{tuple(z.shape)}")
    return err.max().item()


def check_masked(u, mask):
    out = masked_agg_cuda(u, mask)
    again = masked_agg_cuda(u, mask)
    torch.cuda.synchronize()
    ref = masked_agg_plain(u, mask)
    m = mask.to(torch.float32)
    w = m / m.sum().clamp_min(1.0)
    scale = (u * w[:, None]).abs().sum(0)
    err = (out - ref).abs()
    if not bool((err <= 1e-5 * scale + 1e-7).all()):
        raise AssertionError(f"masked_aggregate disagrees at {tuple(u.shape)}:"
                             f" max |err| {err.max().item()}")
    if not torch.equal(out, again):
        raise AssertionError(f"masked_aggregate not bitwise repeatable at "
                             f"{tuple(u.shape)}")
    return out, err.max().item()


def phase_kernels(card):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    for n, d in SHAPES:
        z = torch.randn((n, d), generator=gen, device="cuda")
        g = z + 0.5 * torch.randn((n, d), generator=gen, device="cuda")
        mask = torch.rand((n,), generator=gen, device="cuda") > 0.3
        err_s = check_similarity(z, g)
        _, err_m = check_masked(z, mask)
        # fp32 weights take the kernel's other mask type (the mean rule's)
        check_masked(z, torch.rand((n,), generator=gen, device="cuda"))
        empty, _ = check_masked(z, torch.zeros_like(mask))
        if not bool((empty == 0).all()):
            raise AssertionError(f"all-false mask is not exactly 0 at {(n, d)}")
        if (n, d) == MAIN_SHAPE:
            # 0/1 weights make every product exact, so the kernel's client-
            # ordered fold is the port's left fold bit for bit
            for m in (mask, mask.to(torch.float32)):
                s, cnt = masked_sum_fold(z, m)
                if not torch.equal(masked_agg_cuda(z, m),
                                   s / cnt.clamp_min(1.0)):
                    raise AssertionError("masked_aggregate is not bitwise the "
                                         "left fold of masked_sum_fold")
            log(f"[kernels] masked_aggregate == masked_sum_fold / max(Σm, 1) "
                f"bitwise at {MAIN_SHAPE}, bool and fp32 0/1 masks")

        w = mask.to(torch.float32)
        w = w / w.sum().clamp_min(1.0)
        iters, warm = (20, 3) if d == D_VGG11 else (200, 20)
        t = {"similarity_stats": time_kernel(
            card, "similarity_stats", (n, d),
            (lambda z, g, S: similarity_cuda(z, g),
             lambda z, g, S: similarity_plain(z, g),
             lambda z, g, S: torch.bmm(S, S.transpose(1, 2))),
            (z, g, torch.stack([z, g], dim=1)),
            bound_ms(2 * n * d * 4 + n * 3 * 4, 6 * n * d), err_s,
            iters, warm)}
        del g
        t["masked_aggregate"] = time_kernel(
            card, "masked_aggregate", (n, d),
            (lambda z, mask, w: masked_agg_cuda(z, mask),
             lambda z, mask, w: masked_agg_plain(z, mask),
             lambda z, mask, w: torch.mv(z.T, w)), (z, mask, w),
            bound_ms(n * d * 4 + n + d * 4, 2 * n * d), err_m,   # bool mask
            iters, warm)
        rows[(n, d)] = t
        del z
        torch.cuda.empty_cache()
    log("[kernels] every kernel agrees with its plain version, repeats "
        "bitwise, and maps an all-false mask to exactly 0, at every model "
        "width up to VGG-11's")
    return rows[MAIN_SHAPE]


def make_federation_data():
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y = make_mnist_like(gen, 4600)
    tx, ty = make_mnist_like(torch.Generator(device="cuda").manual_seed(9),
                             1000)
    return FederatedData.from_partitions(partition_sorted_shards(x, y, 23),
                                         10), tx, ty


def train_run(model, data, tx, ty, aggregator, attack, seed, rounds=60,
              quiet=False):
    """One training run: ``seed`` seeds the round draws (cfg.seed) and,
    offset by 100, the enclave sample draw."""
    cfg = FLConfig(rounds=rounds, aggregator=aggregator,
                   attack=AttackConfig(kind=attack, sigma=1e4),
                   batch_size=50, eval_every=rounds, seed=seed)
    fed = Federation.create(
        model, data, tx, ty, cfg,
        torch.Generator(device="cuda").manual_seed(100 + seed))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h = run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    if not quiet:
        log(f"[train] {aggregator:9s} {attack:9s} seed {seed} acc "
            f"{h['final_acc']:.4f} "
            f"TPR {h['mask_tpr'][-1] if h['mask_tpr'] else '-'} "
            f"FPR {h['mask_fpr'][-1] if h['mask_fpr'] else '-'} "
            f"{dt * 1e3 / rounds:.3f} ms/round launches {counts}")
    return h, counts


def detection_scan(model, data, tx, ty, seeds=range(16)):
    """How often the final round's mask is imperfect across seeds.  With
    the enclave's 2-sample guides a benign client's C2 ratio sometimes
    falls just outside (0.5, 2) at a given round, so the bar below is a
    fixed-seed bar, as in the reference's own tests."""
    for attack in ("sign_flip", "gaussian"):
        bad = []
        for s in seeds:
            h, _ = train_run(model, data, tx, ty, "diversefl", attack, s,
                             quiet=True)
            if h["mask_tpr"][-1] != 1.0 or h["mask_fpr"][-1] != 0.0:
                bad.append((s, h["mask_tpr"][-1], h["mask_fpr"][-1]))
        log(f"[train] detection scan, diversefl {attack}, seeds "
            f"{seeds.start}..{seeds.stop - 1}: final-round TPR 1 and FPR 0 "
            f"in {len(seeds) - len(bad)} of {len(seeds)}; imperfect "
            f"(seed, TPR, FPR): {bad}")


def phase_train():
    data, tx, ty = make_federation_data()
    model = softmax_regression()
    train_run(model, data, tx, ty, "diversefl", "sign_flip", SEED,
              rounds=3)                                          # warm-up
    # the main path: every count is 0 just before it and read just after
    h_dfl, main_counts = train_run(model, data, tx, ty, "diversefl",
                                   "sign_flip", SEED)
    h_orc, c_orc = train_run(model, data, tx, ty, "oracle", "sign_flip", SEED)
    h_dfg, c_dfg = train_run(model, data, tx, ty, "diversefl", "gaussian",
                             SEED)
    h_mean, c_mean = train_run(model, data, tx, ty, "mean", "gaussian", SEED)
    detection_scan(model, data, tx, ty)

    assert h_dfl["final_acc"] >= h_orc["final_acc"] - 0.03, \
        (h_dfl["final_acc"], h_orc["final_acc"])
    for h in (h_dfl, h_dfg):
        assert h["mask_tpr"][-1] == 1.0 and h["mask_fpr"][-1] == 0.0, \
            (h["mask_tpr"], h["mask_fpr"])
    assert h_dfg["final_acc"] > h_mean["final_acc"] + 0.3, \
        (h_dfg["final_acc"], h_mean["final_acc"])
    for c in (main_counts, c_dfg):
        assert c == expected_counts("diversefl", 60), c
    for c in (c_orc, c_mean):
        assert c == expected_counts("oracle", 60), c
    log("[train] accuracy and detection bars met; every diversefl round "
        "launched both CUDA kernels")
    return main_counts


def phase_card_vs_cpu():
    """Five rounds on the card and on the CPU from the same injected draws
    must agree: the same masks, and params to fp32 tolerance."""
    rng = np.random.default_rng(7)
    data, tx, ty = make_federation_data()
    model = softmax_regression()
    cfg = FLConfig(rounds=5, aggregator="diversefl",
                   attack=AttackConfig(kind="sign_flip"), batch_size=50)
    s = data.sample_size(cfg.sample_frac)
    enc = torch.from_numpy(np.stack([rng.choice(data.per_client, s,
                                                replace=False)
                                     for _ in range(data.n_clients)]))
    runs = {}
    for dev in ("cuda", "cpu"):
        fed = Federation.create(model, data, tx, ty, cfg, device=dev,
                                enclave_idx=enc)
        body = make_round_body(model, fed, cfg)
        params = model.init(None, dev)
        masks = []
        draw = np.random.default_rng(11)
        with torch.no_grad():
            for i in range(1, cfg.rounds + 1):
                idx = torch.from_numpy(draw.integers(
                    0, data.per_client, (data.n_clients, cfg.batch_size)))
                params, logs = body(params, inv_sqrt_lr(0.05)(i),
                                    batch_idx=idx)
                masks.append(logs["mask"].cpu())
        runs[dev] = ({k: v.cpu() for k, v in params.items()}, masks)
    (p_gpu, m_gpu), (p_cpu, m_cpu) = runs["cuda"], runs["cpu"]
    assert all(torch.equal(a, b) for a, b in zip(m_gpu, m_cpu)), "masks differ"
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], atol=1e-5, rtol=1e-4)
    err = max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
    log(f"[train] card vs CPU, 5 injected rounds: masks equal, params max "
        f"|err| {err:.3g}")


# ----------------------------------------------------------------------
# slice 2: the weighted fold and the median/trimmed-mean kernel
# ----------------------------------------------------------------------

def oddeven_pairs(n):
    """Compare-swaps of an odd-even transposition network of n passes."""
    return sum(len(range(it % 2, n - 1, 2)) for it in range(n))


def check_update(u, w, acc):
    """The weighted fold against its plain left fold: real weights round
    differently under the kernel's fmaf, so within
    1e-5 * (|acc| + Σ|wᵢuᵢ|) + 1e-7; bitwise repeatable; acc untouched.
    ``u`` is fp32 or bf16."""
    acc0 = acc.clone()
    out = masked_agg_update_cuda(u, w, acc)
    again = masked_agg_update_cuda(u, w, acc)
    torch.cuda.synchronize()
    ref = masked_agg_update_plain(u, w, acc)
    scale = acc.abs() + torch.mv(u.to(torch.float32).abs().T, w.abs())
    err = (out - ref).abs()
    if not bool((err <= 1e-5 * scale + 1e-7).all()):
        raise AssertionError(f"masked_agg_update disagrees at "
                             f"{tuple(u.shape)}: max |err| "
                             f"{err.max().item()}")
    if not torch.equal(out, again):
        raise AssertionError(f"masked_agg_update not bitwise repeatable at "
                             f"{tuple(u.shape)}")
    if not torch.equal(acc, acc0):
        raise AssertionError("masked_agg_update modified acc")
    return err.max().item()


def check_robust(u, f):
    """The median/trimmed kernel against its plain version: the median
    bitwise (and equal to the registry's median rule), the trimmed mean
    within 1e-5 * max|u| + 1e-7 per column (the same admitted values,
    summed in another order); bitwise repeatable."""
    med, trim = robust_agg_cuda(u, f)
    med2, trim2 = robust_agg_cuda(u, f)
    torch.cuda.synchronize()
    p_med, p_trim = robust_agg_plain(u, f)
    rule, _ = aggregate("median", u, AggregationContext(f=f))
    if not (torch.equal(med, p_med) and torch.equal(med, rule)):
        raise AssertionError(f"robust_aggregate median differs at "
                             f"{tuple(u.shape)} f={f}: max |err| "
                             f"{(med - p_med).abs().max().item()}")
    err = (trim - p_trim).abs()
    if not bool((err <= 1e-5 * u.abs().amax(0) + 1e-7).all()):
        raise AssertionError(f"robust_aggregate trimmed mean disagrees at "
                             f"{tuple(u.shape)} f={f}: max |err| "
                             f"{err.max().item()}")
    if not (torch.equal(med, med2) and torch.equal(trim, trim2)):
        raise AssertionError(f"robust_aggregate not bitwise repeatable at "
                             f"{tuple(u.shape)} f={f}")
    return err.max().item()


def with_ties(u, sigma=10.0):
    """Exact ties as the same_value attack makes them: two clients send
    the constant sigma, two more repeat client 0, and the first 64
    columns are constant."""
    u[1] = sigma
    u[-1] = sigma
    u[2] = u[0]
    u[3] = u[0]
    u[:, :64] = 0.5
    return u


def phase_kernels_s2(card):
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = {}
    for n, d in SHAPES:
        u = torch.randn((n, d), generator=gen, device="cuda")
        w = torch.rand((n,), generator=gen, device="cuda") * 2.0
        acc = torch.randn((d,), generator=gen, device="cuda")
        err = check_update(u, w, acc)
        zero = masked_agg_update_cuda(u, torch.zeros_like(w), acc)
        if not torch.equal(zero, acc):
            raise AssertionError(f"all-zero weights do not return acc at "
                                 f"{(n, d)}")
        if (n, d) == MAIN_SHAPE:
            m = (w > 1.0).to(torch.float32)       # exact 0/1 products
            if not torch.equal(masked_agg_update_cuda(u, m, acc),
                               masked_agg_update_plain(u, m, acc)):
                raise AssertionError("masked_agg_update is not bitwise the "
                                     "left fold for 0/1 weights")
        rows[("masked_agg_update", n, d)] = (u, w, acc, err)
        log(f"[kernels] masked_agg_update ({n}, {d}): agrees with the left "
            f"fold (max |err| {err:.3g}), repeats bitwise, zero weights "
            f"return acc")
        del u, w, acc, zero
    for n, d in ROBUST_SHAPES:
        errs = []
        for ties in (False, True):
            u = torch.randn((n, d), generator=gen, device="cuda")
            if ties:
                u = with_ties(u)
            for f in (0, 5):
                errs.append(check_robust(u, f))
        log(f"[kernels] robust_aggregate ({n}, {d}): median equal to the "
            f"plain version and the median rule, trimmed mean max |err| "
            f"{max(errs):.3g}, f in (0, 5), with and without ties")
        rows[("robust_aggregate", n, d)] = max(errs)
        del u
    torch.cuda.empty_cache()

    # timings: the Fig. 4 shape for both kernels, VGG-11's for the fold
    timed = {}
    for n, d in (S2_SHAPE, (23, D_VGG11)):
        u = torch.randn((n, d), generator=gen, device="cuda")
        w = torch.rand((n,), generator=gen, device="cuda") * 2.0
        acc = torch.randn((d,), generator=gen, device="cuda")
        big = d == D_VGG11
        iters, warm = (20, 3) if big else (200, 20)
        timed[("masked_agg_update", n, d)] = time_kernel(
            card, "masked_agg_update", (n, d),
            (masked_agg_update_cuda, masked_agg_update_plain,
             lambda u, w, acc: torch.addmv(acc, u.T, w)), (u, w, acc),
            bound_ms(n * d * 4 + n * 4 + 2 * d * 4, 2 * n * d),
            check_update(u, w, acc), iters, warm)
        if not big:
            pairs = oddeven_pairs(n)
            timed[("robust_aggregate", n, d)] = time_kernel(
                card, "robust_aggregate", (n, d),
                (lambda u: robust_agg_cuda(u, F_BUDGET),
                 lambda u: robust_agg_plain(u, F_BUDGET),
                 lambda u: torch.median(u, 0)), (u,),
                bound_ms(n * d * 4 + 2 * d * 4, d * (4 * pairs + 7 * n)),
                check_robust(u, F_BUDGET))
        del u, w, acc
    torch.cuda.empty_cache()
    log("[kernels] slice 2: both kernels agree with their plain versions "
        "at every shape and repeat bitwise")
    return {name: timed[(name,) + S2_SHAPE]
            for name in ("masked_agg_update", "robust_aggregate")}


# ----------------------------------------------------------------------
# slice 2: the paper's baselines and neural-network models
# ----------------------------------------------------------------------

def expected_counts(aggregator, rounds):
    """Kernel launches a run of ``rounds`` rounds must show."""
    c = dict.fromkeys(ops.KERNELS, 0)
    if aggregator == "diversefl":
        c["similarity_stats"] = c["masked_aggregate"] = rounds
    elif aggregator in ("oracle", "mean"):
        c["masked_aggregate"] = rounds
    elif aggregator == "fltrust":
        c["masked_agg_update"] = rounds
    return c


def fl_run(model, data, tx, ty, aggregator, attack, rounds, lr0=0.05,
           seed=SEED, tag="", expect=None, **cfg_kw):
    """One run through the normal entry points, with the launch counts
    set to 0 just before it and read just after; they must equal
    ``expect`` (default: the dense rule's :func:`expected_counts`).
    ``cfg_kw`` sets or overrides FLConfig fields.  Returns the history,
    ms per round and the counts; the peak device memory of the run is
    ``torch.cuda.max_memory_allocated()`` after it."""
    cfg = FLConfig(**{**dict(rounds=rounds, aggregator=aggregator,
                             attack=attack, batch_size=50, l2=0.0005,
                             eval_every=rounds, seed=seed), **cfg_kw})
    fed = Federation.create(
        model, data, tx, ty, cfg,
        torch.Generator(device="cuda").manual_seed(100 + seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    h = run_federated_training(model, fed, cfg, inv_sqrt_lr(lr0))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / rounds
    counts = ops.launch_counts()
    want = expected_counts(aggregator, rounds) if expect is None else expect
    if counts != want:
        raise AssertionError(f"{tag} {aggregator} {cfg_kw}: launches "
                             f"{counts}, expected {want}")
    if not all(bool(torch.isfinite(v).all()) for v in h["params"].values()):
        raise AssertionError(f"{tag} {aggregator}: non-finite params")
    return h, ms, counts


def mnist_federation():
    x, y = make_mnist_like(torch.Generator(device="cuda").manual_seed(0),
                           4600)
    tx, ty = make_mnist_like(torch.Generator(device="cuda").manual_seed(9),
                             800)
    return FederatedData.from_partitions(partition_sorted_shards(x, y, 23),
                                         10), tx, ty


def cifar_federation():
    x, y = make_cifar_like(torch.Generator(device="cuda").manual_seed(0),
                           2300)
    tx, ty = make_cifar_like(torch.Generator(device="cuda").manual_seed(9),
                             500)
    return FederatedData.from_partitions(partition_sorted_shards(x, y, 23),
                                         10), tx, ty


def phase_fig4(card):
    """Fig. 4 at the paper's width: the 3-NN (D = 199,210), 23 sorted-shard
    clients, f = 5, batch 50, inv_sqrt_lr(0.05), l2 = 0.0005, 40 rounds."""
    data, tx, ty = mnist_federation()
    model = mlp3()
    fl_run(model, data, tx, ty, "fltrust", AttackConfig(kind="sign_flip"),
           3)                                                    # warm-up
    grid = {}
    main_counts = None
    for attack in FIG4_ATTACKS:
        acfg = AttackConfig(kind=attack, sigma=10.0)
        for scheme in FIG4_SCHEMES:
            h, ms, counts = fl_run(model, data, tx, ty, scheme, acfg, 40,
                                   tag="fig4")
            grid[(attack, scheme)] = (h["final_acc"], ms)
            if (scheme, attack) == ("fltrust", "sign_flip"):
                main_counts = counts          # slice 2's main path
            log(f"[fig4] 3-NN {attack:10s} {scheme:9s} acc "
                f"{h['final_acc']:.4f} {ms:.3f} ms/round launches "
                f"{ {k: v for k, v in counts.items() if v} } [{card}]")
    log("[fig4] accuracy grid (40 rounds), rows attack, columns "
        + " / ".join(FIG4_SCHEMES) + ":")
    for attack in FIG4_ATTACKS:
        log(f"[fig4]   {attack:10s} " + "  ".join(
            f"{grid[(attack, s)][0]:.4f} ({grid[(attack, s)][1]:.2f} ms)"
            for s in FIG4_SCHEMES))
    for scheme in OTHER_BASELINES:
        h, ms, _ = fl_run(model, data, tx, ty, scheme,
                          AttackConfig(kind="sign_flip", sigma=10.0), 40,
                          tag="fig4")
        if not np.isfinite(h["final_acc"]):
            raise AssertionError(f"{scheme}: accuracy {h['final_acc']}")
        log(f"[fig4] 3-NN sign_flip  {scheme:12s} acc {h['final_acc']:.4f} "
            f"{ms:.3f} ms/round, no kernel launched [{card}]")
    # the reference's bar (tests/test_system.py::test_nn_training_mlp)
    h, ms, _ = fl_run(model, data, tx, ty, "diversefl",
                      AttackConfig(kind="label_flip"), 50, tag="bar")
    log(f"[fig4] bar: diversefl label_flip 50 rounds acc "
        f"{h['final_acc']:.4f} TPR {h['mask_tpr'][-1]} FPR "
        f"{h['mask_fpr'][-1]} {ms:.3f} ms/round [{card}]")
    if not (h["final_acc"] > 0.85 and h["mask_tpr"][-1] >= 0.8):
        raise AssertionError(f"3-NN label_flip bar missed: acc "
                             f"{h['final_acc']}, TPR {h['mask_tpr'][-1]}")
    return main_counts


def phase_fig5(card):
    """Fig. 5: the Appendix-C small CNN on 2,300 CIFAR-like samples, 25
    rounds, lr0 0.08, under sign_flip."""
    data, tx, ty = cifar_federation()
    model = small_cnn()
    fl_run(model, data, tx, ty, "oracle", AttackConfig(kind="sign_flip"), 2,
           lr0=0.08)                                             # warm-up
    for scheme in ("oracle", "diversefl", "median"):
        h, ms, _ = fl_run(model, data, tx, ty, scheme,
                          AttackConfig(kind="sign_flip", sigma=10.0), 25,
                          lr0=0.08, tag="fig5")
        log(f"[fig5] small CNN sign_flip {scheme:9s} acc "
            f"{h['final_acc']:.4f} {ms:.3f} ms/round [{card}]")


def phase_vgg11(card):
    """VGG-11 at its full width (D = 28,146,762): two rounds each of
    diversefl and fltrust on 23 CIFAR-like clients, then two rounds of
    int8 diversefl, dense and streamed in blocks of 8, each after a
    warm-up round."""
    data, tx, ty = cifar_federation()
    model = vgg11()
    acfg = AttackConfig(kind="sign_flip", sigma=10.0)
    fl_run(model, data, tx, ty, "fltrust", AttackConfig(kind="sign_flip"), 1,
           tag="vgg11")                    # warm-up: cuDNN's first calls
    for scheme in ("diversefl", "fltrust"):
        torch.cuda.empty_cache()
        h, ms, counts = fl_run(model, data, tx, ty, scheme, acfg, 2,
                               tag="vgg11")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[vgg11] {scheme:9s} 2 rounds: {ms:.1f} ms/round (after a "
            f"1-round warm-up), acc {h['final_acc']:.4f}, "
            f"launches { {k: v for k, v in counts.items() if v} }, peak "
            f"{peak:.2f} GiB, params finite [{card}]")
    for rounds in (1, 2):                  # warm-up: the codec's ops
        torch.cuda.empty_cache()
        h, ms, counts = fl_run(model, data, tx, ty, "diversefl", acfg,
                               rounds, tag="vgg11", compression="int8")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[vgg11] diversefl dense int8 2 rounds: {ms:.1f} ms/round (after a "
        f"1-round warm-up), acc {h['final_acc']:.4f}, peak {peak:.2f} GiB "
        f"[{card}]")
    stream = dict(streaming=True, client_chunk=CHUNK, compression="int8")
    blocks = -(-data.n_clients // CHUNK)
    for rounds in (1, 2):                  # warm-up: the blocks' shapes
        torch.cuda.empty_cache()
        h, ms, counts = fl_run(
            model, data, tx, ty, "diversefl", acfg, rounds, tag="vgg11",
            expect=stream_counts("diversefl", "int8", rounds, blocks),
            **stream)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[vgg11] diversefl streaming int8, blocks of {CHUNK}, 2 rounds: "
        f"{ms:.1f} ms/round (after a 1-round warm-up), acc "
        f"{h['final_acc']:.4f}, launches "
        f"{ {k: v for k, v in counts.items() if v} }, peak {peak:.2f} GiB "
        f"(the (23, D) fp32 residual plane is "
        f"{23 * D_VGG11 * 4 / 2 ** 30:.2f} GiB), params finite [{card}]")


def phase_card_vs_cpu_s2():
    """Five rounds each of fltrust (under sign_flip) and median on the
    3-NN, on the card and on the CPU from the same minibatch and root ids:
    params within atol 1e-5 / rtol 1e-4, TF32 off."""
    rng = np.random.default_rng(17)
    data, tx, ty = mnist_federation()
    model = mlp3()
    init = model.init(torch.Generator().manual_seed(3), "cpu")
    for scheme in ("fltrust", "median"):
        cfg = FLConfig(rounds=5, aggregator=scheme, l2=0.0005,
                       attack=AttackConfig(kind="sign_flip"), batch_size=50)
        n_total = data.n_clients * data.per_client
        root = torch.from_numpy(rng.choice(
            n_total, max(1, int(cfg.root_frac * n_total)), replace=False))
        enc = torch.from_numpy(np.stack([
            rng.choice(data.per_client, data.sample_size(cfg.sample_frac),
                       replace=False) for _ in range(data.n_clients)]))
        runs = {}
        for dev in ("cuda", "cpu"):
            fed = Federation.create(model, data, tx, ty, cfg, device=dev,
                                    enclave_idx=enc, root_idx=root)
            body = make_round_body(model, fed, cfg)
            params = {k: v.to(dev) for k, v in init.items()}
            draw = np.random.default_rng(11)
            with torch.no_grad():
                for i in range(1, cfg.rounds + 1):
                    idx = torch.from_numpy(draw.integers(
                        0, data.per_client, (data.n_clients, cfg.batch_size)))
                    params, _ = body(params, inv_sqrt_lr(0.05)(i),
                                     batch_idx=idx)
            runs[dev] = {k: v.cpu() for k, v in params.items()}
        for k in runs["cpu"]:
            torch.testing.assert_close(runs["cuda"][k], runs["cpu"][k],
                                       atol=1e-5, rtol=1e-4)
        err = max((runs["cuda"][k] - runs["cpu"][k]).abs().max().item()
                  for k in runs["cpu"])
        log(f"[train] card vs CPU, 3-NN {scheme}, 5 injected rounds: params "
            f"max |err| {err:.3g} (TF32 off)")


# ----------------------------------------------------------------------
# slice 3: streaming aggregation and the compressed uplink
# ----------------------------------------------------------------------

def stream_counts(aggregator, codec, rounds, blocks):
    """Kernel launches of a streaming run: one fold per block (the
    dequantize-and-fold kernel under int8, the weighted fold otherwise)
    and, for diversefl, one similarity pass per block."""
    c = dict.fromkeys(ops.KERNELS, 0)
    fold = "dequant_fold_update" if codec == "int8" else "masked_agg_update"
    c[fold] = rounds * blocks
    if aggregator == "diversefl":
        c["similarity_stats"] = rounds * blocks
    return c


def check_dequant(q, scale, w, acc):
    """The dequantize-and-fold kernel against its plain version (decode,
    then the left fold): real weights round differently under the
    kernel's fmaf, so within 1e-5 * (|acc| + Σ|wᵢ·decᵢ|) + 1e-7; bitwise
    repeatable; acc untouched."""
    acc0 = acc.clone()
    out = dequant_fold_update_cuda(q, scale, w, acc, QBLOCK)
    again = dequant_fold_update_cuda(q, scale, w, acc, QBLOCK)
    torch.cuda.synchronize()
    ref = dequant_fold_update_plain(q, scale, w, acc, QBLOCK)
    scale_ = acc.abs() + torch.mv(dequant_int8(q, scale, QBLOCK).abs().T,
                                  w.abs())
    err = (out - ref).abs()
    if not bool((err <= 1e-5 * scale_ + 1e-7).all()):
        raise AssertionError(f"dequant_fold_update disagrees at "
                             f"{tuple(q.shape)}: max |err| "
                             f"{err.max().item()}")
    if not torch.equal(out, again):
        raise AssertionError(f"dequant_fold_update not bitwise repeatable at "
                             f"{tuple(q.shape)}")
    if not torch.equal(acc, acc0):
        raise AssertionError("dequant_fold_update modified acc")
    return err.max().item()


def update_rows(n, d, gen):
    """(n, d) fp32 rows whose magnitudes span six decades; the first block
    holds values at k + 0.5 after the int8 division and the second is
    all zeros."""
    x = torch.randn((n, d), generator=gen, device=DEV) \
        * torch.logspace(-4, 2, n, device=DEV)[:, None]
    if d >= 2 * QBLOCK:
        x[:, :QBLOCK] = torch.arange(QBLOCK, device=DEV) - 63.5
        x[:, 0] = 127.0
        x[:, QBLOCK:2 * QBLOCK] = 0.0
    return x


def phase_kernels_s3(card):
    gen = torch.Generator(device=DEV).manual_seed(2468)
    int8 = get_codec("int8")
    # the codecs on the card against the CPU's: the encode is a true
    # division, round half to even and a bf16 cast, in both
    x = update_rows(23, D_MLP3, gen)
    for name in ("bf16", "int8"):
        codec = get_codec(name)
        card_enc, cpu_enc = codec.encode(x), codec.encode(x.cpu())
        for key in card_enc:
            if not torch.equal(card_enc[key].cpu(), cpu_enc[key]):
                raise AssertionError(f"{name} encode on the card differs "
                                     f"from the CPU's ({key})")
    log(f"[kernels] bf16 and int8 encodes of (23, {D_MLP3}) on the card "
        f"equal the CPU's bitwise")
    timed = {}
    for n, d in S3_SHAPES:
        x = update_rows(n, d, gen)
        enc = int8.encode(x)
        q, scale = enc["q"], enc["scale"]
        u16 = x.to(torch.bfloat16)
        del x, enc
        w = torch.rand((n,), generator=gen, device=DEV) * 2.0
        acc = torch.randn((d,), generator=gen, device=DEV)
        m = (w > 1.0).to(torch.float32)           # exact 0/1 products
        err = check_dequant(q, scale, w, acc)
        if not torch.equal(dequant_fold_update_cuda(q, scale, m, acc, QBLOCK),
                           dequant_fold_update_plain(q, scale, m, acc,
                                                     QBLOCK)):
            raise AssertionError(f"dequant_fold_update is not bitwise the "
                                 f"left fold for 0/1 weights at {(n, d)}")
        if not torch.equal(dequant_fold_update_cuda(
                q, scale, torch.zeros_like(w), acc, QBLOCK), acc):
            raise AssertionError(f"dequant_fold_update: zero weights do not "
                                 f"return acc at {(n, d)}")
        err16 = check_update(u16, w, acc)
        if not torch.equal(masked_agg_update_cuda(u16, m, acc),
                           masked_agg_update_plain(u16, m, acc)):
            raise AssertionError(f"bf16 masked_agg_update is not bitwise the "
                                 f"left fold for 0/1 weights at {(n, d)}")
        log(f"[kernels] dequant_fold_update ({n}, {d}) qblock {QBLOCK}: "
            f"max |err| {err:.3g}; bf16 masked_agg_update max |err| "
            f"{err16:.3g}; both bitwise the left fold for 0/1 weights, "
            f"repeatable, zero weights return acc")
        if (n, d) == S3_SHAPE:
            # the similarity pass of one streamed diversefl block
            z = dequant_int8(q, scale, QBLOCK)
            g = z + 0.5 * torch.randn((n, d), generator=gen, device=DEV)
            timed[("similarity_stats", n, d)] = time_kernel(
                card, "similarity_stats", (n, d),
                (lambda z, g, S: similarity_cuda(z, g),
                 lambda z, g, S: similarity_plain(z, g),
                 lambda z, g, S: torch.bmm(S, S.transpose(1, 2))),
                (z, g, torch.stack([z, g], dim=1)),
                bound_ms(2 * n * d * 4 + n * 3 * 4, 6 * n * d),
                check_similarity(z, g))
            del z, g
        if (n, d) in (S3_SHAPE, (23, 2_000_000), (CHUNK, D_VGG11)):
            nb = scale.shape[1]
            iters, warm = (20, 3) if d == D_VGG11 else (200, 20)
            timed[("dequant_fold_update", n, d)] = time_kernel(
                card, "dequant_fold_update", (n, d),
                (lambda q, s, w, a: dequant_fold_update_cuda(q, s, w, a,
                                                             QBLOCK),
                 lambda q, s, w, a: dequant_fold_update_plain(q, s, w, a,
                                                              QBLOCK),
                 lambda q, s, w, a: torch.addmv(
                     a, dequant_int8(q, s, QBLOCK).T, w)),
                (q, scale, w, acc),
                bound_ms(n * d + 4 * n * nb + 4 * n + 8 * d, 3 * n * d),
                err, iters, warm)
            if (n, d) != (23, 2_000_000):
                timed[("masked_agg_update bf16", n, d)] = time_kernel(
                    card, "masked_agg_update bf16", (n, d),
                    (masked_agg_update_cuda, masked_agg_update_plain,
                     lambda u, w, a: torch.addmv(a, u.to(torch.float32).T,
                                                 w)),
                    (u16, w, acc),
                    bound_ms(2 * n * d + 4 * n + 8 * d, 2 * n * d), err16,
                    iters, warm)
        del q, scale, u16, w, acc, m
        torch.cuda.empty_cache()
    log("[kernels] slice 3: the dequantize-and-fold kernel and the bf16 "
        "weighted fold agree with their plain versions at every shape")
    return {"dequant_fold_update": timed[("dequant_fold_update",)
                                         + S3_SHAPE]}


def same_run(a, b):
    """Two histories bit for bit: params, accuracy, masks, criterion."""
    return (all(torch.equal(a["params"][k], b["params"][k])
                for k in a["params"])
            and all(a[k] == b[k] for k in ("acc", "mask_tpr", "mask_fpr"))
            and all(np.array_equal(x, y) for x, y in zip(a["c1c2"],
                                                         b["c1c2"])))


def phase_stream(card):
    """Configuration 1: Fig. 4's 3-NN (D = 199,210), 23 sorted-shard
    clients, f = 5 under sign_flip, batch 50, inv_sqrt_lr(0.05), l2 =
    0.0005, streamed in blocks of 8 (8, 8, 7 + 1 padding row) under each
    codec."""
    data, tx, ty = mnist_federation()
    model = mlp3()
    acfg = AttackConfig(kind="sign_flip", sigma=10.0)
    blocks = -(-data.n_clients // CHUNK)
    stream = dict(streaming=True, client_chunk=CHUNK)
    fl_run(model, data, tx, ty, "diversefl", acfg, 2, tag="stream",
           expect=stream_counts("diversefl", "int8", 2, blocks),
           compression="int8", **stream)                         # warm-up
    # streaming against dense, 10 rounds: bitwise against the dense path
    # at the same chunk (the same batched shapes reach cuBLAS); against
    # the unchunked dense path it is printed, not required
    unchunked = {}
    for rule in ("diversefl", "oracle", "mean"):
        for codec in CODECS:
            hs, _, _ = fl_run(model, data, tx, ty, rule, acfg, 10,
                              tag="stream",
                              expect=stream_counts(rule, codec, 10, blocks),
                              compression=codec, **stream)
            hd, _, _ = fl_run(model, data, tx, ty, rule, acfg, 10,
                              tag="stream", compression=codec,
                              client_chunk=CHUNK)
            if not same_run(hs, hd):
                raise AssertionError(f"streaming {rule} {codec} differs from "
                                     f"dense")
            hu, _, _ = fl_run(model, data, tx, ty, rule, acfg, 10,
                              tag="stream", compression=codec)
            unchunked[(rule, codec)] = same_run(hs, hu)
    log(f"[stream] 3-NN, 10 rounds: streaming == dense bitwise for "
        f"diversefl/oracle/mean under f32/bf16/int8 (dense in the same "
        f"blocks of {CHUNK}); also bitwise against the unchunked dense path: "
        f"{unchunked} [{card}]")
    for codec in CODECS:
        hs, _, _ = fl_run(model, data, tx, ty, "fltrust", acfg, 10,
                          tag="stream",
                          expect=stream_counts("fltrust", codec, 10, blocks),
                          compression=codec, **stream)
        hd, _, _ = fl_run(model, data, tx, ty, "fltrust", acfg, 10,
                          tag="stream", compression=codec, client_chunk=CHUNK)
        for k in hd["params"]:
            torch.testing.assert_close(hs["params"][k], hd["params"][k],
                                       atol=1e-5, rtol=1e-4)
        err = max((hs["params"][k] - hd["params"][k]).abs().max().item()
                  for k in hd["params"])
        log(f"[stream] fltrust {codec}: streaming vs dense params max |err| "
            f"{err:.3g} after 10 rounds (Σ TSᵢ summed per block) [{card}]")
    main_counts = None
    for codec in CODECS:
        rules = ("diversefl", "oracle", "mean", "fltrust") \
            if codec == "int8" else ("diversefl", "oracle")
        acc = {}
        for rule in rules:
            h, ms, counts = fl_run(
                model, data, tx, ty, rule, acfg, 40, tag="stream",
                expect=stream_counts(rule, codec, 40, blocks),
                compression=codec, **stream)
            acc[rule] = h["final_acc"]
            if (rule, codec) == ("diversefl", "int8"):
                main_counts = counts          # slice 3's main path
                tpr = h["mask_tpr"][-1]
                if tpr < 0.8:
                    raise AssertionError(f"streaming int8 diversefl TPR {tpr}")
            log(f"[stream] 3-NN {codec:4s} {rule:9s} 40 rounds acc "
                f"{h['final_acc']:.4f} "
                f"TPR {h['mask_tpr'][-1] if h['mask_tpr'] else '-'} "
                f"FPR {h['mask_fpr'][-1] if h['mask_fpr'] else '-'} "
                f"{ms:.3f} ms/round launches "
                f"{ {k: v for k, v in counts.items() if v} } [{card}]")
        if acc["diversefl"] < acc["oracle"] - 0.03:
            raise AssertionError(f"{codec}: diversefl {acc['diversefl']} "
                                 f"below oracle {acc['oracle']} - 0.03")
    log("[stream] bars met under every codec: diversefl >= oracle - 0.03, "
        "TPR >= 0.8; every round launched one fold and (diversefl) one "
        "similarity pass per block")
    return main_counts


def phase_comm(card):
    """Configuration 2: the reference's compressed-uplink deployment
    (benchmarks/comm_bench.py: 256 clients in blocks of 64, streaming
    diversefl, f = 51 under sign_flip) on the paper's 3-NN, 50 MNIST-like
    samples a client, batch 10, 20 rounds, per codec."""
    n, per = 256, 50
    x, y = make_mnist_like(torch.Generator(device="cuda").manual_seed(0),
                           n * per)
    tx, ty = make_mnist_like(torch.Generator(device="cuda").manual_seed(9),
                             800)
    data = FederatedData.from_partitions(partition_sorted_shards(x, y, n), 10)
    model = mlp3()
    acfg = AttackConfig(kind="sign_flip")
    kw = dict(n_clients=n, f=n // 5, batch_size=10, l2=0.0, streaming=True,
              client_chunk=64)
    blocks = n // 64
    fl_run(model, data, tx, ty, "diversefl", acfg, 1, tag="comm",
           expect=stream_counts("diversefl", "int8", 1, blocks),
           compression="int8", **kw)                             # warm-up
    res = {}
    for codec in CODECS:
        torch.cuda.empty_cache()
        h, ms, counts = fl_run(
            model, data, tx, ty, "diversefl", acfg, 20, tag="comm",
            expect=stream_counts("diversefl", codec, 20, blocks),
            compression=codec, **kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        res[codec] = h
        log(f"[comm] N = {n}, blocks of 64, {codec:4s}: acc "
            f"{h['final_acc']:.4f} TPR {h['mask_tpr'][-1]} FPR "
            f"{h['mask_fpr'][-1]}, uplink {h['uplink_bytes_per_client']} "
            f"B/client (reduction {h['uplink_reduction']:.4f}x), "
            f"{ms:.3f} ms/round, peak {peak:.2f} GiB [{card}]")
    if not (res["int8"]["uplink_reduction"] >= 3.5
            and res["int8"]["uplink_bytes_per_client"]
            == D_MLP3 + 4 * -(-D_MLP3 // QBLOCK)
            and res["bf16"]["uplink_reduction"] == 2.0):
        raise AssertionError("uplink reduction off")
    for codec in ("bf16", "int8"):
        gap = abs(res[codec]["final_acc"] - res["f32"]["final_acc"])
        if gap > 0.01:
            raise AssertionError(f"{codec} accuracy {res[codec]['final_acc']} "
                                 f"is {gap} from f32's")
    log("[comm] int8 uplink reduction >= 3.5 and bf16 2.0; bf16 and int8 "
        "final accuracy within 0.01 of f32")


def phase_card_vs_cpu_s3():
    """Three rounds of streaming int8 diversefl on the 3-NN, on the card
    and on the CPU from the same minibatch ids and enclave samples: masks
    equal every round, params within atol 5e-5 / rtol 1e-4.  The atol
    admits a few int8 values that a 1e-7 difference between the devices'
    updates moves across a rounding boundary: each such step moves one
    client's decoded value by its block's scale (about 4e-5 here) and the
    mean by that over the kept count."""
    rng = np.random.default_rng(19)
    data, tx, ty = mnist_federation()
    model = mlp3()
    init = model.init(torch.Generator().manual_seed(3), "cpu")
    cfg = FLConfig(rounds=3, aggregator="diversefl", l2=0.0005,
                   attack=AttackConfig(kind="sign_flip"), batch_size=50,
                   streaming=True, client_chunk=CHUNK, compression="int8")
    enc = torch.from_numpy(np.stack([
        rng.choice(data.per_client, data.sample_size(cfg.sample_frac),
                   replace=False) for _ in range(data.n_clients)]))
    runs = {}
    for dev in (DEV, "cpu"):
        fed = Federation.create(model, data, tx, ty, cfg, device=dev,
                                enclave_idx=enc)
        body = make_round_body(model, fed, cfg)
        carry = ({k: v.to(dev) for k, v in init.items()},
                 torch.zeros((data.n_clients, D_MLP3), device=dev))
        draw = np.random.default_rng(11)
        masks = []
        with torch.no_grad():
            for i in range(1, cfg.rounds + 1):
                idx = torch.from_numpy(draw.integers(
                    0, data.per_client, (data.n_clients, cfg.batch_size)))
                carry, logs = body(carry, inv_sqrt_lr(0.05)(i),
                                   batch_idx=idx)
                masks.append(logs["mask"].cpu())
        runs[dev] = ({k: v.cpu() for k, v in carry[0].items()}, masks)
    (p_gpu, m_gpu), (p_cpu, m_cpu) = runs[DEV], runs["cpu"]
    if not all(torch.equal(a, b) for a, b in zip(m_gpu, m_cpu)):
        raise AssertionError("streaming int8: masks differ, card vs CPU")
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k], p_cpu[k], atol=5e-5, rtol=1e-4)
    err = max((p_gpu[k] - p_cpu[k]).abs().max().item() for k in p_cpu)
    log(f"[train] card vs CPU, 3-NN streaming int8 diversefl, 3 injected "
        f"rounds: masks equal, params max |err| {err:.3g} (TF32 off)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    timings = phase_kernels(card)
    timings.update(phase_kernels_s2(card))
    timings.update(phase_kernels_s3(card))
    counts = phase_train()
    phase_card_vs_cpu()
    # slice 2's main path: Fig. 4's fltrust run (the median run and the
    # other baselines launch no kernel: the reference leaves them to XLA)
    counts_s2 = phase_fig4(card)
    counts.update({k: counts_s2[k] for k in ("masked_agg_update",
                                             "robust_aggregate")})
    phase_fig5(card)
    # slice 3's main path: the streamed int8 diversefl run of [stream]
    counts["dequant_fold_update"] = \
        phase_stream(card)["dequant_fold_update"]
    phase_comm(card)
    phase_vgg11(card)
    phase_card_vs_cpu_s2()
    phase_card_vs_cpu_s3()
    kernels = []
    for name, meta in KERNEL_META.items():
        r = timings[name]
        kernels.append({"name": name, "route": "cuda", **meta,
                        "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
