#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of the repo, one CUDA card

Phases (any failure raises and the script exits non-zero):

  1. device  - the card's name and power limit (nvidia-smi), torch/CUDA
  2. build   - nvcc builds the CUDA kernels from src/repro_torch/kernels/csrc
  3. kernels - each kernel against its plain PyTorch version on the card at
               (23, 7850), (23, 199210), (1024, 7850), (23, 16411), with
               bool, fp32 and all-false masks; bitwise repeatability;
               CUDA-event timings of kernel, plain version and one PyTorch
               library call
  4. train   - the paper's configuration (softmax regression, 23 clients,
               f = 5, 60 rounds): diversefl/oracle under sign_flip and
               diversefl/mean under gaussian, with the reference's accuracy
               and detection bars and the kernels' launch counts; then the
               card's rounds against the CPU's on injected draws
  5. result  - a ``kernels`` JSON line, then ``{"ok": true, ...}`` last
"""
import json
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
from repro_torch.data import (FederatedData, make_mnist_like,  # noqa: E402
                              partition_sorted_shards)
from repro_torch.fl import (FLConfig, Federation,  # noqa: E402
                            make_round_body, run_federated_training,
                            softmax_regression)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.masked_agg import (masked_agg_cuda,  # noqa: E402
                                            masked_agg_plain)
from repro_torch.kernels.similarity import (similarity_cuda,  # noqa: E402
                                            similarity_plain)
from repro_torch.optim import inv_sqrt_lr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
MAIN_SHAPE = (23, 7850)          # 23 clients x softmax regression's D
SEED = 0                         # the training runs' draws (see detection_scan)
SHAPES = [MAIN_SHAPE, (23, 199210), (1024, 7850), (23, 16411)]
KERNEL_META = {
    "similarity_stats": {
        "source": "src/repro_torch/kernels/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity.py:44"},
    "masked_aggregate": {
        "source": "src/repro_torch/kernels/csrc/masked_agg.cu",
        "replaces": "src/repro/kernels/masked_agg.py:84"},
}


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=200, warmup=20):
    """(device ms, host-inclusive ms) per call of ``fn``.

    Device: CUDA events around ``iters`` calls enqueued while a sleep
    kernel holds the stream, so the calls run back to back on the card
    and the Python wrapper's host time is hidden.  Host-inclusive: wall
    clock per call of a synchronised loop, what one call costs an eager
    round.  Both warm, with inputs resident in L2 where they fit."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * host_s * iters + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, host_s * 1e3


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

        S = torch.stack([z, g], dim=1)                    # (n, 2, d)
        w = mask.to(torch.float32)
        w = w / w.sum().clamp_min(1.0)
        sim_bytes = 2 * n * d * 4 + n * 3 * 4
        agg_bytes = n * d * 4 + n + d * 4                 # bool mask in
        calls = {
            "similarity_stats": (
                lambda: similarity_cuda(z, g), lambda: similarity_plain(z, g),
                lambda: torch.bmm(S, S.transpose(1, 2)),
                bound_ms(sim_bytes, 6 * n * d), err_s),
            "masked_aggregate": (
                lambda: masked_agg_cuda(z, mask),
                lambda: masked_agg_plain(z, mask),
                lambda: torch.mv(z.T, w),
                bound_ms(agg_bytes, 2 * n * d), err_m),
        }
        t = {}
        for name, (kern, plain, lib, bound, err) in calls.items():
            (ms, host), (p_ms, p_host), (l_ms, _) = (cuda_ms(kern),
                                                     cuda_ms(plain),
                                                     cuda_ms(lib))
            t[name] = dict(ms=ms, plain_ms=p_ms, library_ms=l_ms,
                           bound=bound, max_abs_err=err)
            log(f"[kernels] {name} ({n}, {d}): device kernel {ms * 1e3:.2f} "
                f"us, plain {p_ms * 1e3:.2f} us, library {l_ms * 1e3:.2f} us,"
                f" bound {bound[0] * 1e3:.3f} us ({bound[1]}); per call with "
                f"host kernel {host * 1e3:.2f} us, plain {p_host * 1e3:.2f} "
                f"us; max |err| {err:.3g} [{card}]")
        rows[(n, d)] = t
    log("[kernels] every kernel agrees with its plain version, repeats "
        "bitwise, and maps an all-false mask to exactly 0")
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
        assert c == {"similarity_stats": 60, "masked_aggregate": 60}, c
    for c in (c_orc, c_mean):
        assert c == {"similarity_stats": 0, "masked_aggregate": 60}, c
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    card = phase_device()
    phase_build()
    timings = phase_kernels(card)
    counts = phase_train()
    phase_card_vs_cpu()
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
