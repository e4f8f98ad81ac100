#!/usr/bin/env python3
"""A quick look at the port's fp32 flash-attention and median/trimmed-mean
kernels on one card, a subset of ``chip_smoke.py`` that runs in about a
minute:

    python3 kernel_probe.py        # from the root of the repo, one CUDA card

It builds every kernel (chip_smoke's build phase: ptxas's register
report; a spill fails the run), runs chip_smoke's checks of the two
kernels (the median/trimmed-mean kernel at every ROBUST_SHAPES entry with
and without ties, its median bitwise the plain version's, the median
rule's and the pre-redesign kernel's; the fp32 flash kernel at its
layout cases, both copy widths, every bucket, split and unsplit), and
times both at the shapes chip_smoke times, inputs cold, with the
pre-redesign kernels (``robust_agg_v1_cuda``,
``flash_attention_simt_v1_cuda``) timed beside them in the same run.
It also sweeps the median kernel's grid and the fp32 flash kernel's key
splits (each held to the default result first), and reads torch.profiler's
device time by kernel at kernel_bench's shape for the flash kernel, its
combine and sdpa.  Exits non-zero on any failure; prints no result line
(``chip_smoke.py`` is the on-card check).
"""
import sys
import time

import torch

import chip_smoke as cs
from repro_torch.kernels import _build, robust_agg
from repro_torch.kernels.flash_attention import (_FP32_ARGTYPES,
                                                 flash_attention_plain,
                                                 fp32_plan)

# fp32 flash shapes to sweep the key-split count at: (B, H, K, S, dh,
# window, softcap)
SPLIT_SHAPES = [(1, 8, 8, 1024, 128, None, None),
                (1, 8, 1, 2048, 256, None, 30.0),
                (1, 16, 4, 2000, 72, 700, None)]


def fp32_with_splits(q, k, v, window, softcap, splits):
    """The fp32 flash kernel launched with ``splits`` key chunks a q tile
    in place of the plan's count (the copy width as planned)."""
    B, H, Sq, dh = q.shape
    K, Sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    tensors = (q, k, v, out)
    strides = [s for t in tensors for s in t.stride()[:3]]
    plan = fp32_plan(B, H, Sq, Sk, dh, window, strides[:9],
                     [t.data_ptr() for t in tensors[:3]],
                     torch.cuda.get_device_properties(0)
                     .multi_processor_count)
    ws_o = torch.empty((splits * B * H * Sq, dh), device=q.device)
    ws_ml = torch.empty((splits * B * H * Sq, 2), device=q.device)
    fn = _build.entry_point("flash_attention", "flash_attention_fwd",
                            _FP32_ARGTYPES)
    code = fn(*(t.data_ptr() for t in tensors), ws_o.data_ptr(),
              ws_ml.data_ptr(), B, H, K, Sq, Sk, dh, *strides,
              1.0 / dh ** 0.5, window or 0, float(softcap or 0.0), splits,
              int(plan.copy_bytes == 16),
              torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", code)
    return out


def sweep_splits(card, gen):
    """Cold times of the fp32 kernel at SPLIT_SHAPES for every split
    count, each held to the plain version at 1e-4 first."""
    for (B, H, K, S, dh, window, softcap) in SPLIT_SHAPES:
        q = torch.randn((B, H, S, dh), generator=gen, device="cuda") * (
            6.0 if softcap else 1.0)
        k = torch.randn((B, K, S, dh), generator=gen, device="cuda")
        v = torch.randn((B, K, S, dh), generator=gen, device="cuda")
        ref = flash_attention_plain(q, k, v, window, softcap)
        times = []
        for splits in range(1, 9):
            torch.testing.assert_close(
                fp32_with_splits(q, k, v, window, softcap, splits), ref,
                atol=1e-4, rtol=1e-4)
            ms = cs.cuda_ms(lambda q, k, v: fp32_with_splits(
                q, k, v, window, softcap, splits), cs.cold_sets(q, k, v),
                50, 5)[0]
            times.append(f"{splits}: {ms * 1e3:.2f}")
        print(f"[probe] fp32 flash {(B, H, K, S, dh, window, softcap)} "
              f"by key splits, us cold: {', '.join(times)} [{card}]",
              flush=True)


def sweep_robust_grid(card, gen):
    """Cold times of the median/trimmed-mean kernel at Fig. 4's shape for
    a range of grid sizes (0: one full wave), each bitwise the default
    launch's result."""
    n, d = cs.S2_SHAPE
    u = torch.randn((n, d), generator=gen, device="cuda")
    want = robust_agg.robust_agg_cuda(u, cs.F_BUDGET)
    times = []
    for blocks in (0, 132, 264, 396, 528, 792, 1056, 1557):
        def run(u, blocks=blocks):
            return robust_agg._launch("robust_agg_f32", u, cs.F_BUDGET,
                                      blocks)
        got = run(u)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"robust_agg with {blocks} blocks differs")
        ms = cs.cuda_ms(run, cs.cold_sets(u))[0]
        times.append(f"{blocks}: {ms * 1e3:.2f}")
    print(f"[probe] robust_aggregate {(n, d)} by grid blocks (0: one full "
          f"wave), us cold: {', '.join(times)} [{card}]", flush=True)


def profile_kernel_bench(card, gen):
    """torch.profiler's device time by kernel for 10 calls each of the
    fp32 flash kernel and sdpa (is_causal) at kernel_bench's shape."""
    q, k, v = (torch.randn((1, 8, 1024, 128), generator=gen, device="cuda")
               for _ in range(3))
    for name, fn in (("flash_attention_cuda", lambda: cs.flash_attention_cuda(
            q, k, v)), ("sdpa is_causal", lambda: torch.nn.functional.
                        scaled_dot_product_attention(q, k, v, is_causal=True,
                                                     enable_gqa=True))):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        rows = cs.device_kernels(prof)
        print(f"[probe] kernel_bench fp32 {name}, device us a call by "
              f"kernel: " + "; ".join(f"{ms * 100:.2f} {key[:90]}"
                                      for ms, key in rows[:4])
              + f" [{card}]", flush=True)


def main():
    if not torch.cuda.is_available():
        print("kernel_probe: needs one CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cs.check_robust_shapes(gen)
    cs.check_flash_fp32_cases(gen)
    print(f"[probe] checks passed ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for n, d in (cs.S2_SHAPE, (23, cs.D_VGG11)):
        u = torch.randn((n, d), generator=gen, device="cuda")
        iters, warm = (20, 3) if d == cs.D_VGG11 else (200, 20)
        cs.time_robust(card, u, iters, warm)
        del u
        torch.cuda.empty_cache()
    sweep_robust_grid(card, gen)
    sweep_splits(card, gen)
    profile_kernel_bench(card, gen)
    cs.time_flash(card, gen, dtypes=(torch.float32,))
    print(f"[probe] done ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
