"""The dry run on tensor-parallel params: what a rank holds at train_4k on
the 16 x 16 mesh.

For every zoo architecture, ``launch.dryrun``'s round step is traced
under ``FakeTensorMode`` on rank 0 of a fake 256-rank group, its params
this rank's tiles (``sharding.place_params`` on the 16-way model axis).
Each config keeps its published widths and is cut to one pass of its
layout (plus its dense prelude and one encoder layer), which changes how
many leaves there are and nothing of what a rank holds of each.  Held:
``argument_size_in_bytes`` equals the bytes of the tiles that
``sharding.param_shardings`` gives plus the step's inputs
(``launch.shapes.train_inputs``, whole on every rank: the step cuts its
client's block itself), exactly; and it is below the whole params'.
"""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs, models, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, train_inputs


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg):
    kw = dict(n_layers=cfg.first_k_dense + len(cfg.layout))
    if cfg.is_enc_dec:
        kw["n_enc_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def _bytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_train_4k_arguments_are_the_tiles_and_the_inputs(arch):
    cfg = _cut(configs.get(arch))
    shape = SHAPES["train_4k"]
    meta = models.init(None, cfg, "meta")
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        sharding.client_group(mesh)
        ms = dict(zip(mesh.mesh_dim_names, mesh.shape))["model"]
        specs = sharding.param_shardings(meta, mesh)
        leaves = sharding.api._paths(meta)
        tiles = sum(
            _bytes(leaf) // math.prod(ms for n in spec if n is not None)
            for (_, leaf), spec in zip(
                leaves, _spec_leaves(specs)))
        inputs = sum(_bytes(t) for t in train_inputs(cfg, shape, mesh)[0]
                     .values())
        with FakeTensorMode():
            fn, args, kwargs = dryrun._step(cfg, shape, mesh, False, "cpu")
            rec = dryrun.trace(fn, *args, **kwargs)
    assert not dist.is_initialized()
    whole = sum(_bytes(leaf) for _, leaf in leaves)
    assert rec["memory"]["argument_size_in_bytes"] == tiles + inputs
    assert tiles < whole


def _spec_leaves(specs):
    """The spec tuples of a ``param_shardings`` tree, in leaf order."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                   and isinstance(specs[0], dict)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]
