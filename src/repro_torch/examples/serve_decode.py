"""Serving example: prefill a prompt, then batched greedy decode against
the KV/SSM cache — the same decode step the decode_32k / long_500k dry
runs trace, here on a reduced config.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch jamba-v0-1-52b                                   # the card
    ... --device cpu
"""
import argparse

import numpy as np
import torch

from .. import configs, models
from ..device import resolve_device

NEAR_TIE = 1e-3      # a greedy step whose top-2 logit gap is under this


@torch.inference_mode()
def generate(cfg, params, prompt, gen: int, device=None):
    """Decode ``prompt`` (B, P) token by token into a cache of P + gen
    entries, teacher-forcing the prompt, then ``gen`` greedy steps (a
    shape-stable cache; a production server runs the batched prefill
    instead).  The cache is written in place.  -> ``(tokens (B, P + gen)
    int32, gaps (B, P + gen) fp32)`` on the host: ``gaps[:, j]`` is the
    top-2 logit gap of the step that chose token ``j`` (inf where the
    prompt forced it)."""
    dev = resolve_device(device)
    prompt = prompt.to(dev)
    B, P = prompt.shape
    cache_len = P + gen
    cache = models.init_cache(cfg, B, cache_len, dev)
    tok = prompt[:, :1].to(torch.int32)
    out = [tok]
    gaps = [torch.full((B, 1), float("inf"), device=dev)]
    for t in range(cache_len - 1):
        lg, cache = models.decode_step(params, cfg, tok, cache, t)
        if t + 1 < P:
            tok = prompt[:, t + 1:t + 2].to(torch.int32)  # teacher-force
            gaps.append(torch.full((B, 1), float("inf"), device=dev))
        else:
            tok = torch.argmax(lg, -1).to(torch.int32)   # greedy
            top2 = torch.topk(lg[:, 0].float(), 2, dim=-1).values
            gaps.append((top2[:, :1] - top2[:, 1:]))
        out.append(tok)
    return (torch.cat(out, dim=1).cpu().numpy(),
            torch.cat(gaps, dim=1).cpu().numpy())


def agree_until_tie(a, b, gaps, tol: float = NEAR_TIE) -> list:
    """Per sequence, how many leading tokens of ``a`` and ``b`` are held
    equal: every token before the first step whose gap (``gaps``, the
    elementwise least of both runs') is under ``tol``, where a rounding
    may pick the other token.  Raises on a difference before it."""
    a, b, gaps = np.asarray(a), np.asarray(b), np.asarray(gaps)
    held = []
    for i in range(a.shape[0]):
        ties = np.nonzero(gaps[i] < tol)[0]
        n = int(ties[0]) if ties.size else a.shape[1]
        if not np.array_equal(a[i, :n], b[i, :n]):
            j = int(np.nonzero(a[i, :n] != b[i, :n])[0][0])
            raise AssertionError(
                f"sequence {i}: token {j} differs ({a[i, j]} against "
                f"{b[i, j]}, gap {gaps[i, j]:.3g}) before the first "
                f"near-tie at {n}")
        held.append(n)
    return held


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    choices=configs.all_arch_ids())
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch, smoke=True)
    params = models.init(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    toks, gaps = generate(cfg, params, prompt, args.gen, dev)
    print(f"{args.arch} (reduced): generated {args.gen} tokens x "
          f"{args.batch} sequences")
    rows = []
    for b in range(args.batch):
        seq = toks[b, args.prompt_len:]
        rows.append({"seq": b, "tokens": seq.tolist(),
                     "min_gap": float(gaps[b, args.prompt_len:].min())})
        print(f"  seq{b}: " + " ".join(str(int(x)) for x in seq))
    return rows


if __name__ == "__main__":
    main()
