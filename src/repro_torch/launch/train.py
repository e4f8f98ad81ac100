"""The FL round step at pod scale: DiverseFL Steps 2-5 as one SPMD program
over the client x model mesh, on ``torch.distributed``.

Each FL client is one (pod, data) coordinate of the mesh.  Every rank runs
``round_fn`` on its own client's batch (the reference's ``shard_map``,
manual over the client axes); the reference's ``psum``/``pmean`` over the
client axes are ``all_reduce`` on the client group:

  1. client local SGD (E steps) on the local batch  -> update z_j
  2. (test-only) simulated Byzantine corruption of z_j
  3. guiding update Δ̃_j on the client's enclave sample (same E, same lr)
  4. per-client similarity scalars                             [C1/C2]
  5. masked mean over the client axes: one all_reduce a leaf    [Eq. 6]

On a model axis > 1 the params are the rank's tiles
(``sharding.place_params``) and each client's update is computed split
over its model group (``sharding/api.py``): the update of a tiled leaf is
the tile's, the similarity scalars sum the tiles' partials over the
model group, and the masked mean and the step run on the tiles.  At a
trivial mesh no collective is issued.

``main`` is the launcher: federated training of a zoo arch through the
round engine on the host mesh, on the card unless ``--device cpu``:

    python -m repro_torch.launch.train --arch gemma-2b --rounds 10
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import models
from ..convert import flatten_tree, unflatten_like
from ..core.diversefl import (DiverseFLConfig, criterion_logs, diversefl_mask,
                              similarity_stats_tree)
from ..sharding import (all_gather, all_reduce, client_group, client_put,
                        model_group, model_shard_count, partition_pytree,
                        use_mesh)
from .mesh import client_axes, n_clients
from .shapes import sds

F32 = torch.float32

# simulated fault codes (RNG-free; integration testing only, 0 in
# production)
FAULT_NONE, FAULT_SIGN_FLIP, FAULT_SAME_VALUE, FAULT_SCALE = 0, 1, 2, 3
SAME_VALUE_SIGMA = 100.0
SCALE_FACTOR = 5.0


def update_psum_dtype(update_dtype):
    """The dtype client updates are all-reduced in: fp32 under gloo (the
    reference's CPU gate, kept so both packages reduce the same numbers;
    gloo in torch 2.13 does reduce bf16), the update dtype under NCCL."""
    backend = dist.get_backend() if dist.is_initialized() else None
    return update_dtype if backend == "nccl" else F32


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def resolve_update_dtype(compression: str, update_dtype=None):
    """The wire dtype the round step carries client updates in, from the
    codec registry (``fl/compression``): a dense-payload codec (f32,
    bf16) is a dtype choice here.  A codec with a scale sidecar (int8)
    has no single wire dtype and raises by name; ``update_dtype``, the
    legacy knob, must agree with ``compression`` (or ``compression`` must
    be the default)."""
    from ..fl.compression import get_codec
    codec = get_codec(compression)
    if codec.wire_dtype is None:
        raise ValueError(
            f"compression={compression!r} has no dense wire dtype: the "
            f"pod-scale shard_map round step psums native update arrays "
            f"and cannot carry the {compression!r} scale sidecar — use "
            f"'f32'/'bf16' here, or run the int8 path through the "
            f"simulator's streaming fold (fl/engine.py)")
    if update_dtype is not None and update_dtype != codec.wire_dtype \
            and compression != "f32":
        raise ValueError(
            f"update_dtype={_dtype_name(update_dtype)!r} conflicts "
            f"with compression={compression!r} "
            f"(wire dtype {_dtype_name(codec.wire_dtype)!r})")
    return update_dtype if update_dtype is not None else codec.wire_dtype


def _local_batch(inputs):
    b = {"tokens": inputs["tokens"]}
    for k in ("enc_emb", "cross_emb"):
        if k in inputs:
            b[k] = inputs[k]
    return b


def _guide_batch(inputs):
    b = {"tokens": inputs["guide_tokens"][0]}
    for k in ("enc_emb", "cross_emb"):
        if "guide_" + k in inputs:
            b[k] = inputs["guide_" + k][0]
    return b


def make_fl_round_step(cfg, mesh, dfl: DiverseFLConfig = DiverseFLConfig(),
                       lr: float = 1e-3, local_steps: int = 1,
                       donate: bool = True, update_dtype=None,
                       robust_mode: str = "diversefl",
                       compression: str = "f32"):
    """Returns ``round_step(params, inputs) -> (new_params, metrics)``,
    which every rank of ``mesh`` calls with the same arguments.

    ``inputs`` is the dict of ``launch.shapes.train_inputs`` (tokens (B,
    S), guide_tokens (nc, gb, S), byz_kind (nc,), rng, the embeddings an
    arch needs), whole on every rank: each rank takes its own client's
    block of the client-axis dim.  ``params`` is the ``models.init`` tree:
    whole off a model axis, this rank's tiles on one
    (``sharding.place_params(params, mesh)``); the new params come back
    the same way.  ``compression``/``update_dtype`` name the
    dtype updates are carried and reduced in (:func:`resolve_update_dtype`).
    ``robust_mode``: ``"diversefl"`` (per-client criteria and the masked
    mean) or ``"median"`` (the coordinate-wise median of every client's
    update, all-gathered: the cross-client baseline; an even count
    averages the middle pair).  ``donate`` is accepted for the
    reference's signature and is inert: the new params are fresh tensors.

    metrics: ``loss`` (the clients' mean), ``kept``, and per client
    ``mask``, ``c1``, ``c2`` (nc,).  ``round_step.client_update(params,
    batch) -> (z, loss)`` is Step 2 alone (z keyed like
    ``convert.flatten_tree(params)``), for checks."""
    if robust_mode not in ("diversefl", "median"):
        raise ValueError(f"robust_mode must be 'diversefl' or 'median', got "
                         f"{robust_mode!r}")
    nc = n_clients(mesh)
    UDT = resolve_update_dtype(compression, update_dtype)
    caxes = client_axes(mesh)
    # the whole leaves' shapes: a leaf of another shape is this rank's tile
    whole = flatten_tree(models.init(None, cfg, "meta")) \
        if model_shard_count(mesh) > 1 else {}

    def stats(z, g):
        """(z·g, ‖z‖², ‖g‖²) of the whole update: the tiles' partials
        summed over the model group, each whole leaf counted once."""
        tiled = {k for k in whole if z[k].shape[-len(whole[k].shape):]
                 != whole[k].shape} if whole else set()
        if not tiled:
            return similarity_stats_tree(z, g)
        part = torch.stack(similarity_stats_tree(
            {k: z[k] for k in tiled}, {k: g[k] for k in tiled}))
        part = all_reduce(part, model_group(mesh))
        rest = similarity_stats_tree(
            {k: v for k, v in z.items() if k not in tiled},
            {k: v for k, v in g.items() if k not in tiled})
        return tuple(a + b for a, b in zip(rest, part.unbind(0)))

    def psum(x):
        return x if nc == 1 else all_reduce(x, client_group(mesh))

    def gather(x):
        return x.unsqueeze(0) if nc == 1 else all_gather(x, client_group(mesh))

    def loss_and_grad(flat, like, batch):
        leaves = [p.detach().requires_grad_(True) for p in flat.values()]
        with torch.enable_grad():
            loss = models.loss_fn(unflatten_like(like, leaves), cfg, batch)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as jax.grad gives
        return loss.detach(), {k: torch.zeros_like(p) if d is None else d
                               for (k, p), d in zip(flat.items(), g)}

    def client_update(flat, like, batch):
        """Δ = θ0 - θE after E local SGD steps (E = 1: lr · grad), in UDT."""
        if local_steps == 1:
            loss, g = loss_and_grad(flat, like, batch)
            return {k: (lr * v.to(F32)).to(UDT) for k, v in g.items()}, loss
        loss = None
        theta = flat
        for _ in range(local_steps):
            step_loss, g = loss_and_grad(theta, like, batch)
            loss = step_loss if loss is None else loss
            theta = {k: (t.to(F32) - lr * g[k].to(F32)).to(t.dtype)
                     for k, t in theta.items()}
        return {k: (flat[k].to(F32) - theta[k].to(F32)).to(UDT)
                for k in flat}, loss

    def round_fn(params, inputs):
        flat = flatten_tree(params)
        # ---- Step 2: client local training on the local shard ----
        z, loss = client_update(flat, params, _local_batch(inputs))

        # ---- simulated Byzantine faults (integration testing) ----
        kind = inputs["byz_kind"][0]
        one = torch.ones((), dtype=F32, device=kind.device)
        mult = torch.where(kind == FAULT_SIGN_FLIP, -one, one) * \
            torch.where(kind == FAULT_SCALE, one * SCALE_FACTOR, one)
        z = {k: torch.where(kind == FAULT_SAME_VALUE,
                            torch.full((), SAME_VALUE_SIGMA, dtype=u.dtype,
                                       device=u.device),
                            u * mult.to(u.dtype)) for k, u in z.items()}
        mean_loss = psum(loss.to(F32).clone()) / nc

        if robust_mode == "median":
            # every client's update on every rank: N x the update memory
            # and the collective, deliberately (the baseline's cost)
            def med(u):
                srt = torch.sort(gather(u), dim=0).values
                h = nc // 2
                return srt[h] if nc % 2 else (srt[h - 1] + srt[h]) / 2
            new = {k: (p.to(F32) - med(z[k]).to(F32)).to(p.dtype)
                   for k, p in flat.items()}
            dev = loss.device
            metrics = {"loss": mean_loss,
                       "kept": torch.tensor(float(nc), device=dev),
                       "mask": torch.ones((1,), dtype=torch.bool, device=dev),
                       "c1": torch.ones((1,), device=dev),
                       "c2": torch.ones((1,), device=dev)}
            return unflatten_like(params, list(new.values())), metrics

        # ---- Step 3: guiding update on the enclave sample ----
        g, _ = client_update(flat, params, _guide_batch(inputs))

        # ---- Step 4: per-client similarity scalars ----
        dot, zz, gg = stats(z, g)
        mask = diversefl_mask(dot, zz, gg, dfl)

        # ---- Step 5: masked mean over clients (Eq. 6) + model update ----
        m = mask.to(F32)
        cnt = psum(m.clone())
        denom = cnt.clamp_min(1.0)
        psum_dt = update_psum_dtype(UDT)
        new = {k: (p.to(F32) - psum((z[k] * m.to(z[k].dtype)).to(psum_dt))
                   .to(F32) / denom).to(p.dtype) for k, p in flat.items()}
        crit = criterion_logs(dot, zz, gg)
        metrics = {"loss": mean_loss, "kept": cnt,
                   "mask": gather(mask.reshape(1)).reshape(nc),
                   "c1": gather(crit["c1"].reshape(1)).reshape(nc),
                   "c2": gather(crit["c2"].reshape(1)).reshape(nc)}
        return unflatten_like(params, list(new.values())), metrics

    def round_step(params, inputs):
        with use_mesh(mesh), torch.no_grad():
            for k, v in inputs.items():
                if k != "rng" and v.shape[0] % nc:
                    raise ValueError(
                        f"inputs[{k!r}] has {v.shape[0]} rows on the client "
                        f"axis, which does not tile the {nc} clients of the "
                        f"mesh's {caxes} axes")
            local = {k: v if k == "rng" else client_put(v)
                     for k, v in inputs.items()}
            return round_fn(params, local)

    round_step.client_update = lambda params, batch: client_update(
        flatten_tree(params), params, batch)
    return round_step


def sharded_param_specs(cfg, mesh):
    """The model params as meta-device tensors at their whole shapes, each
    beside its placement ``(mesh, spec)`` under the partition table
    (``launch.shapes.sds``); ``sharding.place_params`` cuts a rank's tiles
    to it."""
    shapes = models.init(None, cfg, "meta")
    specs = partition_pytree(shapes)

    def pair(s, sp):
        if isinstance(s, dict):
            return {k: pair(s[k], sp[k]) for k in s}
        if isinstance(s, (tuple, list)):
            return type(s)(pair(a, b) for a, b in zip(s, sp))
        return sds(tuple(s.shape), s.dtype, mesh, sp)
    return pair(shapes, specs)


# ----------------------------------------------------------------------
# Launcher CLI: federated training of a zoo arch on the host client x
# model mesh, driven by the round engine (fl/engine.py), the same Steps
# 2-5 every simulator run uses.  make_fl_round_step above is the explicit
# SPMD lowering; no launcher loops over it.
#
#   python -m repro_torch.launch.train --arch gemma-2b --rounds 10
# ----------------------------------------------------------------------

def main(argv=None):
    import argparse
    import tempfile

    from ..core.attacks import AttackConfig
    from ..device import resolve_device
    from ..fl.engine import RoundEngine
    from ..fl.simulator import FLConfig, host_sync
    from ..fl.zoo import make_zoo_federation, zoo_model
    from .mesh import init_local_group, make_host_mesh, n_clients as _nc

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rounds", "--steps", dest="rounds", type=int,
                    default=10)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--byzantine", type=int, default=1,
                    help="number of sign-flipping clients")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    tmp = None
    if own_group:
        # a one-rank group of our own: a FileStore, no network
        tmp = tempfile.TemporaryDirectory()
        init_local_group(0, 1, "nccl" if dev.type == "cuda" else "gloo",
                         store_path=tmp.name + "/store")
    try:
        n = dist.get_world_size()
        mesh = make_host_mesh(data=max(1, n // 2), model=2 if n > 1 else 1,
                              device=dev.type)
        nc = _nc(mesh)
        model = zoo_model(args.arch, seq_len=args.seq, smoke=True)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"launch: {model.name} ({model.param_count():,} params) on "
              f"mesh {sizes} ({nc} clients)")
        cfg = FLConfig(
            n_clients=nc, f=args.byzantine, rounds=args.rounds,
            batch_size=args.batch, l2=0.0, aggregator="diversefl",
            streaming=True, eval_every=min(args.eval_every, args.rounds),
            attack=AttackConfig(kind="sign_flip" if args.byzantine
                                else "none"))
        fed = make_zoo_federation(model, cfg, per_client=max(args.batch, 8),
                                  device=dev)
        engine = RoundEngine(model, fed, cfg, mesh=mesh)
        params, _, metrics, eval_rounds = engine.run_training(
            model.init(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                       dev),
            torch.Generator(device=dev).manual_seed(cfg.seed),
            torch.full((cfg.rounds,), args.lr, dtype=F32, device=dev))
        host = host_sync(metrics)
        for r, acc in zip(eval_rounds, host["acc"]):
            print(f"  round {int(r):3d} acc={float(acc):.4f}")
        del params
    finally:
        if own_group:
            dist.destroy_process_group()
            tmp.cleanup()


if __name__ == "__main__":
    main()
