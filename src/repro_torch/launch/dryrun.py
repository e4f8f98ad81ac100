"""Dry run: trace every (architecture x input shape x production mesh)
combination on a fake process group of 256 or 512 ranks, and read what one
rank holds, computes and moves.  No real allocation: every tensor is a
``FakeTensor`` (shape, dtype and device, no storage) on the resolved
device, the card unless ``--device cpu`` is given.

The reference lowers and compiles each combination for 512 fake XLA
devices and reads XLA's ``memory_analysis``/``cost_analysis`` and the
collectives of the compiled HLO.  The port runs the real step eagerly under
``FakeTensorMode`` on rank 0 of a ``"fake"`` process group
(``torch.testing._internal.distributed.fake_pg``), where every collective
returns at once, and counts as it goes (:func:`trace`):

- ``cost["flops"]``: ``torch.utils.flop_counter.FlopCounterMode``'s total;
- ``cost["bytes accessed"]``: the bytes of every aten op's tensor operands
  and results (view ops move none).  An unfused upper bound: XLA counts
  after fusion, so the two differ most where XLA fuses elementwise chains;
- ``memory``: ``argument_size_in_bytes`` (the storages of the step's
  arguments: this rank's tiles of the params, ``sharding.place_params`` on
  the 16-way model axis, and its inputs), ``output_size_in_bytes`` (the
  results' storages that are not arguments) and ``temp_size_in_bytes``
  (the peak of the live storages the step made, on top of the arguments,
  outputs live at the peak included: what ``torch.cuda.max_memory_
  allocated()`` above the bytes held before the step reads on the card).
  The reference's ``generated_code_size``/``alias_size`` have no
  counterpart;
- ``collectives``: ``launch.hlo.collective_stats`` of the records of
  ``sharding.record_collectives``;
- ``ops``: the ``launch.hlo.op_census`` of the dispatched ops.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu   # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
      --shape train_4k --mesh both
  ... --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from .. import configs, models
from ..core.diversefl import DiverseFLConfig
from ..device import resolve_device
from . import hlo as hlo_lib
from ..sharding import client_group, place_params
from .mesh import make_production_mesh
from .serve import make_prefill, make_serve_step
from .shapes import SHAPES, applicable, serve_inputs, train_inputs
from .train import make_fl_round_step

SKIP_REASON = ("full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group as rank 0 of ``world`` fake ranks; it is
    destroyed on the way out.  Refuses to stack on a live group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a default process group is already "
                           "initialised; the dry run builds its own fake "
                           "group of the production mesh's ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_tree(tree, device):
    """A tree of meta tensors (``launch.shapes``, ``models.init(...,
    "meta")``) as fake tensors on ``device``; call under an active
    ``FakeTensorMode``."""
    return tree_map(lambda t: torch.empty(tuple(t.shape), dtype=t.dtype,
                                          device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storages(tensors, skip=()) -> WeakIdKeyDictionary:
    """The distinct storages of ``tensors`` not in ``skip``, each mapped
    to its bytes."""
    out = WeakIdKeyDictionary()
    for t in tensors:
        s = t.untyped_storage()
        if s not in skip:
            out[s] = s.nbytes()
    return out


class _Census(TorchDispatchMode):
    """Every aten op of the step: counted by name, its operand and result
    bytes summed (not for views), and each new storage among its results
    live from its creation until Python frees it (a finaliser)."""

    def __init__(self, args):
        super().__init__()
        self.held = _storages(_tensors(args))
        self.made = WeakIdKeyDictionary()
        self.ops = collections.Counter()
        self.bytes = 0
        self.live = self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops[func.overloadpacket.__name__] += 1
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            s = t.untyped_storage()
            if s in self.held or s in self.made:
                continue
            n = s.nbytes()
            self.made[s] = n
            weakref.finalize(s, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def trace(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once, under an active
    ``FakeTensorMode`` with fake arguments, and return the record's
    ``cost``, ``memory``, ``collectives``, ``collective_bytes``,
    ``roofline`` and ``ops`` (module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import ops as kops
    from ..sharding import record_collectives
    before = kops.launch_counts()
    with record_collectives() as recs, \
            FlopCounterMode(display=False) as flops, \
            _Census((args, kwargs)) as census:
        out = fn(*args, **kwargs)
    ops = collections.Counter(census.ops)
    for name, n in kops.launch_counts().items():
        ops[name] += n - before[name]
    for r in recs:
        ops[r["kind"]] += 1
    cost = {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(census.bytes)}
    held = _storages(_tensors((args, kwargs)))
    memory = {
        "argument_size_in_bytes": sum(held.values()),
        "output_size_in_bytes": sum(_storages(_tensors(out), held).values()),
        "temp_size_in_bytes": census.peak}
    coll = hlo_lib.collective_stats(recs)
    cbytes = hlo_lib.total_collective_bytes(recs)
    return {"cost": cost, "memory": memory, "collectives": coll,
            "collective_bytes": cbytes,
            "roofline": hlo_lib.roofline_terms(cost, cbytes),
            "ops": hlo_lib.op_census(ops)}


def _step(cfg, shape, mesh, opt, dev):
    """(fn, args, kwargs) of the combination's step, its arguments fake
    tensors on ``dev`` (under an active ``FakeTensorMode``): the params
    are this rank's tiles."""
    params = fake_tree(place_params(models.init(None, cfg, "meta"), mesh),
                       dev)
    if shape.kind == "train":
        specs, _ = train_inputs(cfg, shape, mesh)
        step = make_fl_round_step(
            cfg, mesh, DiverseFLConfig(), donate=False,
            compression="bf16" if opt else "f32")
        return step, (params, fake_tree(specs, dev)), {}
    if shape.kind == "prefill":
        tok = torch.empty((shape.batch, shape.seq), dtype=torch.int32,
                          device=dev)
        kwargs = {}
        if cfg.is_enc_dec:
            kwargs["enc_emb"] = torch.empty(
                (shape.batch, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        elif cfg.has_cross:
            kwargs["cross_emb"] = torch.empty(
                (shape.batch, cfg.n_patches, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        return make_prefill(cfg, mesh), (params, tok), kwargs
    specs, _ = serve_inputs(cfg, shape, mesh)
    x = fake_tree(specs, dev)
    return (make_serve_step(cfg, mesh, donate_cache=False),
            (params, x["token"], x["cache"], x["cache_index"]), {})


def dryrun_one(arch_id: str, shape_name: str, multi_pod: bool,
               verbose: bool = True, opt: bool = False,
               device=None) -> dict:
    """Trace one combination on rank 0 of a fake group of the production
    mesh's ranks (256, or 512 with ``multi_pod``); the record of the
    module docstring with ``arch``, ``shape``, ``mesh``, ``kind``,
    ``status`` (``ok``/``skip``), ``opt`` and ``trace_s``.  Refuses a
    config with ``use_kernels`` on: a kernel wrapper would launch on a
    fake CUDA tensor's missing storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    cfg = configs.get(arch_id)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "status": "ok", "opt": opt}
    if not applicable(cfg, shape):
        rec["status"] = "skip"
        rec["reason"] = SKIP_REASON
        if verbose:
            print(f"[skip] {arch_id:22s} {shape_name:12s} {mesh_name:8s} "
                  f"{SKIP_REASON}")
        return rec
    if cfg.use_kernels:
        raise ValueError(
            f"dryrun: {arch_id} has use_kernels=True; the dry run traces "
            f"the plain path only (a kernel wrapper would launch on fake "
            f"tensors, which have no storage)")
    dev = resolve_device(device)
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev.type)
        # the client axes' group is built on first use, from real tensors:
        # build it before any tensor is fake
        client_group(mesh)
        with FakeTensorMode():
            fn, args, kwargs = _step(cfg, shape, mesh, opt, dev)
            rec.update(trace(fn, *args, **kwargs))
    rec["trace_s"] = round(time.time() - t0, 2)
    if verbose:
        r, m = rec["roofline"], rec["memory"]
        print(f"[{rec['status']:4s}] {arch_id:22s} {shape_name:12s} "
              f"{mesh_name:8s} trace={rec['trace_s']:7.1f}s "
              f"flops={r['flops']:.3e} bytes={r['bytes']:.3e} "
              f"coll={r['collective_bytes']:.3e} dom={r['dominant']}")
        print(f"       memory: {m}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--bf16", "--opt", dest="opt", action="store_true",
                    help="the bf16 update codec in the round step "
                         "(fl/compression.py; --opt is the legacy "
                         "spelling)")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)

    archs = configs.all_arch_ids() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    records.append(dryrun_one(arch, shape, mp, opt=args.opt,
                                              device=args.device))
                except Exception as e:   # recorded, printed, counted
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": "2x16x16" if mp else "16x16",
                                    "status": "error", "error": repr(e)})
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} documented skips, {n_err} errors")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print("wrote", args.out)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
