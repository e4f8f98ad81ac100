"""End to end: federated training of a ~100M-parameter LM through
the round engine on a data x model mesh of local ranks: by default 4 data
x 2 model = 8 ranks, 4 FL clients.  One client is Byzantine (sign flip):
watch its updates get filtered while accuracy climbs.

This is the engine path (``fl/engine.RoundEngine(mesh=...)``): the same
Steps 2-5 every simulator run, sweep and benchmark runs, with the
federated state (updates, guides, the fold) model-sharded over the
mesh's ``model`` axis in the blocked (ms, L) layout while every rank keeps
the whole params (``sharding/api.py``).  The ranks are processes started
by ``launch.mesh.spawn_local``: gloo on ``--device cpu``, NCCL on the
card, where NCCL takes one rank a card.

    PYTHONPATH=src python -m repro_torch.examples.train_fl_llm \\
        --device cpu --rounds 20                       # 8 gloo ranks
    PYTHONPATH=src python -m repro_torch.examples.train_fl_llm \\
        --data 1 --model 1 --rounds 20                 # one card
"""
import argparse
import dataclasses
import time

import torch

from ..checkpoint import save_checkpoint
from ..core.attacks import AttackConfig
from ..device import resolve_device
from ..fl import FLConfig, RoundEngine, make_zoo_federation, zoo_model
from ..fl.simulator import host_sync
from ..launch.mesh import make_host_mesh, spawn_local
from ..models import ModelConfig

N_CLIENTS = 4
TIMEOUT = 3600.0     # seconds the ranks (and each collective) may take


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", "--steps", dest="rounds", type=int,
                    default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data", type=int, default=4,
                    help="ranks on the mesh's data axis")
    ap.add_argument("--model", type=int, default=2,
                    help="ranks on the mesh's model axis")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    return ap.parse_args(argv)


def llm_config(args) -> ModelConfig:
    return ModelConfig(
        name="fl-llm-100m", n_layers=args["layers"],
        d_model=args["d_model"], n_heads=8, n_kv_heads=4,
        d_ff=4 * args["d_model"], vocab_size=32_000,
        attn_direct_max=args["seq"])


def train(args: dict, dev, mesh, seed=None):
    """The run on this rank: fl-llm-100m at ``args``' widths, streaming
    diversefl through the engine on ``mesh``, every draw from ``seed``
    (FLConfig's default when None).  -> (engine, final params, host
    metrics per eval, eval rounds, model, seconds of engine run and host
    sync)."""
    model = zoo_model(llm_config(args), seq_len=args["seq"])
    fl = FLConfig(
        n_clients=N_CLIENTS, f=1, rounds=args["rounds"], batch_size=2,
        l2=0.0, aggregator="diversefl", streaming=True,
        eval_every=min(args["eval_every"], args["rounds"]),
        attack=AttackConfig(kind="sign_flip"))  # client set by byz_mask
    if seed is not None:
        fl = dataclasses.replace(fl, seed=seed)
    fed = make_zoo_federation(model, fl, per_client=8, n_test=32,
                              device=dev)
    engine = RoundEngine(model, fed, fl, mesh=mesh)
    t0 = time.perf_counter()
    params, _, metrics, eval_rounds = engine.run_training(
        model.init(torch.Generator(device=dev).manual_seed(fl.seed + 1),
                   dev),
        torch.Generator(device=dev).manual_seed(fl.seed),
        torch.full((fl.rounds,), args["lr"], dtype=torch.float32,
                   device=dev))
    host = host_sync(metrics)
    return (engine, params, {k: v for k, v in host.items() if k != "_tel"},
            [int(r) for r in eval_rounds], model, time.perf_counter() - t0)


def _rank(rank: int, world: int, args: dict) -> dict:
    """One rank of the run (``spawn_local``): the engine on the host mesh;
    rank 0 writes the checkpoint and returns the final params."""
    from ..kernels import ops
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args["device"] == "cuda" else torch.device("cpu"))
    mesh = make_host_mesh(data=args["data"], model=args["model"],
                          device=dev.type)
    engine, params, metrics, eval_rounds, model, seconds = train(args, dev,
                                                                 mesh)
    out = {"eval_rounds": eval_rounds, "metrics": metrics,
           "seconds": seconds, "launches": ops.launch_counts(),
           "param_count": model.param_count(),
           "model_shards": engine.model_shards,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
    if rank == 0:
        final = {k: v.cpu() for k, v in engine.carry_params(params).items()}
        if args["ckpt"]:
            save_checkpoint(args["ckpt"], args["rounds"], final)
        out["params"] = final
    return out


def run(args, timeout: float = TIMEOUT):
    """Start the ``data x model`` ranks and run, within ``timeout``
    seconds; -> rank 0's result:
    ``eval_rounds``, host ``metrics`` per eval, ``seconds`` (the engine
    run and its host sync), ``launches`` (the kernel wrappers' counts on
    rank 0), ``param_count``, ``model_shards``, ``mesh``, ``params``."""
    dev = resolve_device(args.device)
    world = args.data * args.model
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"train_fl_llm: a {args.data} data x {args.model} model mesh "
            f"needs {world} NCCL ranks, and NCCL takes one rank a card; "
            f"this host has {torch.cuda.device_count()}: pass --data 1 "
            f"--model 1 (or a mesh of at most that many ranks), or "
            f"--device cpu for gloo ranks")
    rank_args = dict(vars(args), device=dev.type)
    return spawn_local(_rank, world, (rank_args,),
                       backend="nccl" if dev.type == "cuda" else "gloo",
                       timeout=timeout)[0]


def report(args, res) -> list:
    """Print :func:`run`'s result as the reference prints its run; -> one
    row per eval: ``round``, ``acc``, ``tpr`` (the sign-flip client's
    detection rate)."""
    print(f"model: {res['param_count'] / 1e6:.1f}M params; mesh "
          f"{res['mesh']} -> {N_CLIENTS} FL clients, federated state "
          f"{res['model_shards']}-way model-sharded")
    m = res["metrics"]
    rows = []
    for i, r in enumerate(res["eval_rounds"]):
        row = {"round": r, "acc": float(m["acc"][i]),
               "tpr": float(m["mask_tpr"][i])}
        rows.append(row)
        print(f"round {r:4d} acc={row['acc']:.4f} "
              f"byz-detect-tpr={row['tpr']:.2f}")
    print(f"{args.rounds} rounds in {res['seconds']:.1f}s "
          f"({res['model_shards']}-way model-sharded federated state)")
    if args.ckpt:
        print("checkpoint saved to", args.ckpt)
    return rows


def main(argv=None):
    args = parse_args(argv)
    return report(args, run(args))


if __name__ == "__main__":
    main()
