"""Mesh construction on ``torch.distributed``.

One pod: ``("data", "model")``; several: ``("pod", "data", "model")``.  FL
clients live on the (pod, data) axes and the model axis splits each
client's parameters (``sharding/api.py``).  The production meshes are
16 x 16 (256 ranks) and 2 x 16 x 16 (512).

A mesh spans the ranks of the initialised default process group, which
:func:`init_local_group` sets up on one host through a ``FileStore``: no
TCP port, no network, and a timeout so that a hung collective fails.
:func:`spawn_local` starts ``world`` such ranks and collects what each
returns.  Meshes are built on the card (``"cuda"``, NCCL) unless the
caller asks for ``"cpu"`` (gloo); with no card and no device given they
raise, as ``device.resolve_device`` does.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..device import resolve_device

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} spans the ranks of the default process group, which "
            f"is not initialised: call launch.mesh.init_local_group (or "
            f"torch.distributed.init_process_group) in every rank first")
    return dist.get_world_size()


def _mesh(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=axes)


def _exact(shape, world, what):
    need = 1
    for s in shape:
        need *= s
    if need != world:
        raise ValueError(
            f"{what} spans {need} ranks but the process group has {world}; "
            f"start exactly {need} ranks")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 ``("data", "model")``, or 2 x 16 x 16 with ``pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES_3D if multi_pod else AXES_2D
    world = _world("make_production_mesh")
    _exact(shape, world, f"the production mesh {shape}")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` mesh over the group's ranks, the counts
    clamped to the world as the reference clamps them to its devices."""
    n = _world("make_host_mesh")
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    _exact((data, model), n, f"host mesh ({data} data x {model} model)")
    return _mesh((data, model), AXES_2D, device)


def make_host_pod_mesh(pods: int = 2, data: int = 1, model: int = 1,
                       device=None):
    """A ``("pod", "data", "model")`` mesh over the group's ranks, for the
    hierarchical two-tier aggregation (``fl/streaming.py``).  Fails with a
    named error when the world is too small."""
    n = _world("make_host_pod_mesh")
    need = pods * data * model
    if n < need:
        raise ValueError(
            f"host pod mesh ({pods} pods x {data} data x {model} model) "
            f"needs {need} ranks but only {n} are in the process group; "
            f"start {need} ranks (launch.mesh.spawn_local)")
    _exact((pods, data, model), n,
           f"host pod mesh ({pods} pods x {data} data x {model} model)")
    return _mesh((pods, data, model), AXES_3D, device)


def client_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def n_clients(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = 1
    for a in client_axes(mesh):
        out *= sizes[a]
    return out


# ----------------------------------------------------------------------
# Ranks on one host
# ----------------------------------------------------------------------

def init_local_group(rank: int, world: int, backend: str = "gloo",
                     store_path: str = None, timeout: float = 120.0):
    """Join the default process group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (one file every rank of the group
    names).  ``timeout`` seconds bound every collective."""
    if store_path is None:
        raise ValueError("init_local_group needs store_path: the FileStore "
                         "file every rank of the group shares")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank, fn, world, backend, workdir, timeout, threads, args):
    torch.set_num_threads(threads)
    init_local_group(rank, world, backend, os.path.join(workdir, "store"),
                     timeout)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_local(fn, world: int, args: tuple = (), *, backend: str = "gloo",
                timeout: float = 120.0, threads: int = 1,
                workdir: str = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    by :func:`init_local_group`; returns each rank's return value (saved
    with ``torch.save``), in rank order.  ``fn`` must be importable by
    name.  A rank that raises fails the call with its traceback; ranks
    still running after ``timeout`` seconds are killed and the call
    raises ``TimeoutError``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, d, timeout, threads, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"spawn_local: {world} ranks of {fn.__name__} still "
                        f"running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
