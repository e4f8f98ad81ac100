#!/usr/bin/env python3
"""A quick look at three CUDA kernels of the port on one card, a subset of
``chip_smoke.py`` that runs in under a minute:

    python3 kernel_probe.py        # from the root of the repo, one CUDA card

It builds every kernel (chip_smoke's build phase: ptxas's register
report; a spill fails the run), runs chip_smoke's checks of the segmented
similarity kernel and of the dequantize-and-fold kernel at its ragged
shapes, holds the bf16 flash kernel to one bf16 step of its plain version
at every shape chip_smoke times (and times it, inputs cold), and times
similarity_stats and dequant_fold_update at the shapes their paths run,
with the launch floor beside them: each kernel at a trivial shape, warm.
Exits non-zero on any failure; prints no result line (``chip_smoke.py``
is the on-card check).
"""
import sys
import time

import torch

import chip_smoke as cs
from repro_torch.fl.compression import get_codec


def main():
    if not torch.cuda.is_available():
        print("kernel_probe: needs one CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    card = cs.phase_device()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    int8 = get_codec("int8")
    cs.check_similarity_rows(gen)
    cs.check_dequant_cases(gen)
    print(f"[probe] checks passed ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    for (B, H, K, S, dh, window, softcap, tag) in cs.FLASH_SHAPES:
        qscale = 6.0 if softcap else 1.0
        q = (torch.randn((B, H, S, dh), generator=gen, device="cuda")
             * qscale).bfloat16()
        k = torch.randn((B, K, S, dh), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, K, S, dh), generator=gen, device="cuda").bfloat16()
        err, ratio, probe = cs.check_flash(q, k, v, window, softcap)
        flops = 4 * dh * cs.attn_pairs(S, window) * B * H
        iters = 5 if flops > 1e11 else 50
        ms = cs.cuda_ms(lambda q, k, v: cs.flash_attention_cuda(
            q, k, v, window, softcap), cs.cold_sets(q, k, v), iters, 2)[0]
        print(f"[probe] flash {tag}: max |err| {err:.3g}, / one bf16 step "
              f"{ratio:.3g}, probe {probe:.3g}; cold {ms * 1e3:.2f} us, "
              f"{flops / ms / 1e9:.1f} TFLOP/s [{card}]", flush=True)
        del q, k, v

    # the launch floor: each kernel at a trivial shape, warm (a cold set
    # of such small inputs would take millions of copies)
    z, g = cs.similarity_inputs(1, 4, gen)
    enc = int8.encode(torch.randn((1, 16), generator=gen, device="cuda"))
    one = (enc["q"], enc["scale"], torch.ones(1, device="cuda"),
           torch.zeros(16, device="cuda"))
    for name, fn, args in (
            ("similarity_stats (1, 4)", cs.similarity_cuda, (z, g)),
            ("dequant_fold_update (1, 16)",
             lambda *a: cs.dequant_fold_update_cuda(*a, cs.QBLOCK), one),
            ("the pre-redesign dequant_fold_update (1, 16)",
             lambda *a: cs.dequant_fold_update_percolumn_cuda(*a, cs.QBLOCK),
             one)):
        ms = cs.cuda_ms(fn, [args])[0]
        print(f"[probe] launch floor, {name}: {ms * 1e3:.2f} us warm "
              f"[{card}]", flush=True)

    for n, d in [(23, 7850), (23, cs.D_MLP3), (8, cs.D_MLP3),
                 (23, cs.D_VGG11)]:
        z, g = cs.similarity_inputs(n, d, gen)
        iters, warm = (20, 3) if d == cs.D_VGG11 else (200, 20)
        cs.time_kernel(card, "similarity_stats", (n, d),
                       (lambda z, g: cs.similarity_cuda(z, g),
                        lambda z, g: cs.similarity_plain(z, g), None),
                       (z, g), cs.bound_ms(2 * n * d * 4 + n * 12, 6 * n * d),
                       cs.check_similarity(z, g), iters, warm)
        del z, g
        torch.cuda.empty_cache()
    for n, d in [(8, cs.D_MLP3), (64, cs.D_MLP3), (23, 2_000_000),
                 (8, cs.D_VGG11)]:
        enc = int8.encode(cs.update_rows(n, d, gen))
        q, scale = enc["q"], enc["scale"]
        w = torch.rand((n,), generator=gen, device="cuda") * 2.0
        acc = torch.randn((d,), generator=gen, device="cuda")
        iters, warm = (20, 3) if d == cs.D_VGG11 else (200, 20)
        cs.time_dequant(card, (q, scale, w, acc),
                        cs.check_dequant(q, scale, w, acc), iters, warm)
        del q, scale, w, acc, enc
        torch.cuda.empty_cache()
    print(f"[probe] done ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
