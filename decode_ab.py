#!/usr/bin/env python3
"""Greedy decode, ms per step, of two trees of the port on one card, run
in turn: a dense, an MoE and an encoder-decoder config at their
published widths and depths in bf16, each serving B = 2 requests at the
context [serve] and [serve-s7b] of ``chip_smoke.py`` decode at.

    python3 decode_ab.py --old DIR [--runs 3] [--steps 32] [--out F]

``DIR`` holds the other tree (its ``src/repro_torch``, e.g. a
``git archive`` of the parent commit); this tree is ``src/``.  Each run is
a fresh process on one tree, in the order old, new, new, old, old,
new, ... (``--runs`` of each), so a drift of the host's speed falls on
both alike.  A process times, per config, ``--steps`` steps of
``launch.serve.make_serve_step`` on the host clock around synchronised
ends (after 4 untimed steps), then sums torch.profiler's device time over
4 more.  The cache holds zeros: every step reads its whole length all the
same.  Prints a line per run and the spread of each tree; ``--out``
writes the runs as JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import time

# (arch, B, context): h2o-danube-1.8b as [serve], its 4,096 ring wrapped;
# deepseek-moe-16b and whisper-medium as [serve-s7b]
CASES = (("h2o-danube-1.8b", 2, 8192), ("deepseek-moe-16b", 2, 4096),
         ("whisper-medium", 2, 448))
WARM, PROFILED = 4, 4


def worker(steps):
    import torch

    from repro_torch import configs, models
    from repro_torch.launch.serve import make_serve_step
    dev = torch.device("cuda")
    out = {}
    for arch, B, S in CASES:
        cfg = configs.get(arch)
        params = models.init(torch.Generator(device=dev).manual_seed(0),
                             cfg, dev)
        cache = models.init_cache(cfg, B, S + WARM + steps + PROFILED, dev)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev)
        step = make_serve_step(cfg)
        t = S
        for _ in range(WARM):
            tok, cache = step(params, tok, cache, t)
            t += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = step(params, tok, cache, t)
            t += 1
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                tok, cache = step(params, tok, cache, t)
                t += 1
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        ) / 1e3 / PROFILED
        out[arch] = {"ms_step": ms, "device_ms_step": device_ms}
        del params, cache
        torch.cuda.empty_cache()
    print(json.dumps(out))


def run_tree(src, steps):
    env = dict(os.environ, PYTHONPATH=src)
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", "--steps", str(steps)], env=env,
                       capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise RuntimeError(f"decode_ab worker on {src} failed:\n{p.stderr}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="root of the other tree")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.steps)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"old": os.path.join(os.path.abspath(args.old), "src"),
             "new": os.path.join(here, "src")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    runs = []
    for i in range(args.runs):
        for which in (("old", "new") if i % 2 == 0 else ("new", "old")):
            r = run_tree(trees[which], args.steps)
            runs.append({"tree": which, **r})
            print(f"{which}: " + "; ".join(
                f"{a} {v['ms_step']:.3f} ms/step (device "
                f"{v['device_ms_step']:.3f})" for a, v in r.items()),
                flush=True)
    for arch, _, _ in CASES:
        for which in ("old", "new"):
            ms = sorted(r[arch]["ms_step"] for r in runs
                        if r["tree"] == which)
            dev = sorted(r[arch]["device_ms_step"] for r in runs
                         if r["tree"] == which)
            print(f"{arch} {which}: ms/step {ms[len(ms) // 2]:.3f} median, "
                  f"{ms[0]:.3f}..{ms[-1]:.3f}; device ms/step "
                  f"{dev[0]:.3f}..{dev[-1]:.3f} [{smi}]")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "steps": args.steps, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
