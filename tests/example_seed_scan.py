#!/usr/bin/env python3
"""Seed scans of the two example bars that miss at the examples' own
seeds, in the JAX reference and in the PyTorch port, on the CPU:

* quickstart's diversefl under sign_flip (60 rounds, 23 clients, 5
  Byzantine): TPR 1 and FPR 0 at round 60.  Seed s draws the rounds from
  ``FLConfig(seed=s)`` and the federation from key / generator seed
  2 + s, so s = 0 is the example's own draw.
* train_fl_llm at the CPU test's widths (2 layers x 64 wide, S = 32, 4
  clients, 1 sign-flipped), 5 rounds with the eval at round 5, the
  card's run cut to those widths: TPR 1 at round 5.  Seed s is
  ``FLConfig(seed=s)``, which draws the data, the params and the rounds;
  s = 0 is the example's.  The reference runs on its 4 data x 2 model
  mesh of 8 simulated host devices, the port on a 1 x 1 gloo mesh (its 2
  x 2 mesh gives the same masks bit for bit).

    PYTHONPATH=src python3 tests/example_seed_scan.py [--seeds 16] [--out F]

The two packages draw from different generators, so a seed names a
different draw in each: what compares is how often each meets the bar.
Prints a row per seed and the counts; ``--out`` writes them as JSON.
"""
import argparse
import json
import os
import time

# the reference's train_fl_llm builds its 4 x 2 mesh on 8 host devices
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import torch  # noqa: E402

LLM = dict(layers=2, d_model=64, seq=32, rounds=5, lr=3e-2)


def _jax():
    import jax
    # the reference's guide cache calls jax.core.trace_state_clean, which
    # JAX 0.9 moved (ROADMAP's known hazards of the reference)
    jax.core.trace_state_clean = jax._src.core.trace_state_clean
    return jax


def ref_quickstart(seeds):
    jax = _jax()
    from repro.core.attacks import AttackConfig
    from repro.data import (FederatedData, make_mnist_like,
                            partition_sorted_shards)
    from repro.fl import FLConfig, Federation, run_federated_training
    from repro.fl.small_models import softmax_regression
    from repro.optim import inv_sqrt_lr
    x, y = make_mnist_like(jax.random.PRNGKey(0), 4600)
    tx, ty = make_mnist_like(jax.random.PRNGKey(9), 1000)
    data = FederatedData.from_partitions(partition_sorted_shards(x, y, 23),
                                         10)
    model = softmax_regression()
    out = []
    for s in seeds:
        cfg = FLConfig(rounds=60, aggregator="diversefl",
                       attack=AttackConfig(kind="sign_flip", sigma=1e4),
                       batch_size=50, eval_every=60, seed=s)
        fed = Federation.create(model, data, tx, ty, cfg,
                                jax.random.PRNGKey(2 + s))
        h = run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))
        out.append({"tpr": float(h["mask_tpr"][-1]),
                    "fpr": float(h["mask_fpr"][-1]),
                    "acc": float(h["final_acc"])})
    return out


def port_quickstart(seeds):
    from repro_torch.examples import quickstart
    from repro_torch.fl.small_models import softmax_regression
    dev = torch.device("cpu")
    data, tx, ty = quickstart.paper_data(dev)
    model = softmax_regression()
    return [quickstart.run(model, data, tx, ty, "diversefl", "sign_flip",
                           dev, seed=s, fed_seed=2 + s) for s in seeds]


def ref_llm(seeds):
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np
    from repro.core.attacks import AttackConfig
    from repro.fl import FLConfig, RoundEngine, make_zoo_federation, zoo_model
    from repro.launch.mesh import make_host_mesh
    from repro.models import ModelConfig
    d = LLM["d_model"]
    cfg = ModelConfig(name="fl-llm-100m", n_layers=LLM["layers"], d_model=d,
                      n_heads=8, n_kv_heads=4, d_ff=4 * d,
                      vocab_size=32_000, attn_direct_max=LLM["seq"])
    mesh = make_host_mesh(data=4, model=2)
    model = zoo_model(cfg, seq_len=LLM["seq"])
    out = []
    for s in seeds:
        fl = FLConfig(n_clients=4, f=1, rounds=LLM["rounds"], batch_size=2,
                      l2=0.0, aggregator="diversefl", streaming=True,
                      eval_every=LLM["rounds"],
                      attack=AttackConfig(kind="sign_flip"), seed=s)
        fed = make_zoo_federation(model, fl, per_client=8, n_test=32)
        engine = RoundEngine(model, fed, fl, mesh=mesh)
        _, _, m, _ = engine.run_training(
            model.init(jax.random.PRNGKey(s + 1)), jax.random.PRNGKey(s),
            jnp.full((fl.rounds,), LLM["lr"], jnp.float32))
        out.append({k: float(np.asarray(m[f"mask_{k}"])[-1])
                    for k in ("tpr", "fpr")})
    return out


def _port_llm_rank(rank, world, seeds):
    from repro_torch.examples import train_fl_llm
    from repro_torch.launch.mesh import make_host_mesh
    args = dict(vars(train_fl_llm.parse_args([
        "--layers", str(LLM["layers"]), "--d-model", str(LLM["d_model"]),
        "--seq", str(LLM["seq"]), "--rounds", str(LLM["rounds"]),
        "--lr", str(LLM["lr"])])), device="cpu")
    dev = torch.device("cpu")
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    out = []
    for s in seeds:
        m = train_fl_llm.train(args, dev, mesh, seed=s)[2]
        out.append({k: float(m[f"mask_{k}"][-1]) for k in ("tpr", "fpr")})
    return out


def port_llm(seeds):
    from repro_torch.launch.mesh import spawn_local
    return spawn_local(_port_llm_rank, 1, (list(seeds),), timeout=3600)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = list(range(args.seeds))
    res = {}
    for name, fn in (("port quickstart", port_quickstart),
                     ("port train_fl_llm", port_llm),
                     ("reference quickstart", ref_quickstart),
                     ("reference train_fl_llm", ref_llm)):
        t = time.perf_counter()
        res[name] = fn(seeds)
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    summary = {}
    for pkg in ("reference", "port"):
        qs, llm = res[f"{pkg} quickstart"], res[f"{pkg} train_fl_llm"]
        summary[pkg] = {
            "quickstart held": [s for s, r in zip(seeds, qs)
                                if r["tpr"] == 1.0 and r["fpr"] == 0.0],
            "train_fl_llm held": [s for s, r in zip(seeds, llm)
                                  if r["tpr"] == 1.0]}
    print(f"{'seed':>4s}  {'quickstart TPR/FPR ref':>22s} {'port':>12s}  "
          f"{'train_fl_llm TPR ref':>20s} {'port':>5s}")
    for i, s in enumerate(seeds):
        q = [res[f"{p} quickstart"][i] for p in ("reference", "port")]
        t = [res[f"{p} train_fl_llm"][i]["tpr"]
             for p in ("reference", "port")]
        print(f"{s:4d}  {q[0]['tpr']:10.2f}/{q[0]['fpr']:.4f} "
              f"{q[1]['tpr']:5.2f}/{q[1]['fpr']:.4f}  {t[0]:20.2f} "
              f"{t[1]:5.2f}")
    for pkg, s in summary.items():
        print(f"{pkg}: quickstart bar held at {len(s['quickstart held'])} "
              f"of {len(seeds)} seeds {s['quickstart held']}; train_fl_llm "
              f"bar at {len(s['train_fl_llm held'])} of {len(seeds)} "
              f"{s['train_fl_llm held']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"seeds": seeds, "runs": res, "summary": summary}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
