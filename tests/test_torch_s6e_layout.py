"""Tensor parallelism on the model axis: the placement of the params and
the blocked layout's twins on tiles (``repro_torch.sharding``).

Pure layout identities, bitwise, for every zoo family's SMOKE params at
model axes 2 and 4 (the mesh coordinates from a stand-in mesh):

* ``place_params`` cuts each leaf that the partition table tiles to this
  rank's tile along its split dim (a fresh contiguous tensor) and keeps
  the rest; a rank then holds exactly the bytes the table gives it;
* ``BlockedLayout.local_cut`` of a whole flat matrix is the flat matrix of
  the tiles, and ``local_rows`` of that is ``rows`` of the whole;
* a model with no tiled leaf (the paper's small models) is placed as it
  is.

On gloo ranks (``launch.mesh.spawn_local``, one torch thread a rank):
``gather_params`` of the tiles is the whole params, one ``all_gather`` a
tiled leaf; ``unravel_local`` of a rank's row is its tiles of ``unravel``
of the whole (ms, L) matrix, from one ``all_gather`` of the whole leaves'
columns only; ``shard_params`` refuses a leaf off its tile's shape; the
autograd operators' gradients equal the one-process gradient of the same
sum; and a remat region's recomputation, run in the backward pass on
another thread (as the autograd engine runs it for CUDA tensors), splits
as its forward did.
"""
import dataclasses
import math
import threading

import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.convert import flatten_tree
from repro_torch.fl import small_models, zoo_model
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.sharding import api

ARCHS = configs.all_arch_ids()
RANK_TIMEOUT = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Mesh:
    """The attributes the placement reads from a DeviceMesh: a 1 x ms
    ("data", "model") mesh seen from model rank ``s``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, ms, s):
        self.shape, self._coord = (1, ms), [0, s]

    def get_coordinate(self):
        return self._coord


def _params(arch):
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype="float32", param_dtype="float32")
    return flatten_tree(models.init(torch.Generator().manual_seed(0), cfg,
                                    "cpu"))


def _flat(tree, scale=1.0):
    return torch.cat([v.reshape(-1) * scale for v in tree.values()])


@pytest.mark.parametrize("ms", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tiles_and_local_rows_are_the_wholes(arch, ms):
    p = _params(arch)
    layout = sharding.blocked_layout(p, ms)
    flat = torch.stack([_flat(p), _flat(p, -2.0)])
    whole_bytes = sum(v.numel() * v.element_size() for v in p.values())
    n_split = 0
    for s in range(ms):
        tiles = sharding.place_params(p, _Mesh(ms, s))
        mine = 0
        for k, t in tiles.items():
            d = api._model_split(api._ref_path(k), p[k].shape, ms)
            if d is None:
                assert t is p[k], k
                mine += t.numel() * t.element_size()
                continue
            n = p[k].shape[d] // ms
            assert t.is_contiguous() and t.untyped_storage().data_ptr() != \
                p[k].untyped_storage().data_ptr(), k
            assert torch.equal(t, p[k].narrow(d, s * n, n)), k
            mine += p[k].numel() // ms * p[k].element_size()
            n_split += s == 0
        # the bytes a rank holds: its tiles and the whole leaves
        assert sum(t.numel() * t.element_size()
                   for t in tiles.values()) == mine < whole_bytes
        tflat = torch.stack([_flat(tiles), _flat(tiles, -2.0)])
        assert torch.equal(layout.local_cut(flat, s), tflat)
        assert torch.equal(layout.local_rows(tflat, s), layout.rows(flat, s))
    assert n_split > 0
    assert layout.D == flat.shape[1] and layout.L * ms >= layout.D


@pytest.mark.parametrize("name", ["softmax_regression", "mlp3",
                                  "small_cnn", "vgg11"])
def test_a_model_with_no_tiled_leaf_is_placed_as_it_is(name):
    model = getattr(small_models, name)()
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    tiles = sharding.place_params(p, _Mesh(2, 1))
    assert all(tiles[k] is p[k] for k in p)


# ----------------------------------------------------------------------
# on gloo ranks
# ----------------------------------------------------------------------

def _rank(rank, world):
    mesh = make_host_mesh(world // 2, 2, device="cpu")
    s, group = sharding.model_index(mesh), sharding.model_group(mesh)
    out = {"s": s}
    p = _params("jamba-v0.1-52b")          # attention, Mamba, MoE leaves
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in p.items()}
    with sharding.use_mesh(mesh):
        tiles = sharding.place_params(p, mesh)
        n_tiled = sum(tiles[k].shape != p[k].shape for k in p)
        before = sharding.collective_counts()
        with sharding.record_collectives() as recs:
            back = sharding.gather_params(tiles, like, mesh)
        out["gather_counts"] = {k: v - before[k] for k, v in
                                sharding.collective_counts().items()}
        out["gather_recs"] = len(recs)
        out["n_tiled"] = n_tiled
        out["round_trip"] = all(torch.equal(back[k], p[k]) for k in p)
        assert sharding.shard_params(tiles, like) is tiles
        bad = dict(tiles)
        k0 = next(k for k in p if tiles[k].shape != p[k].shape)
        bad[k0] = p[k0]
        try:
            sharding.shard_params(bad, like)
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
        # the delta's row -> the rank's tiles
        layout = sharding.blocked_layout(like, 2)
        M = torch.randn((2, layout.L),
                        generator=torch.Generator().manual_seed(5))
        with sharding.record_collectives() as recs:
            got = layout.unravel_local(M[s], s, group)
        want = sharding.place_params(layout.unravel(M), mesh)
        out["unravel_local"] = all(torch.equal(got[k], want[k]) for k in p)
        out["unravel_recs"] = [(r["kind"], r["shape"]) for r in recs]
        out["whole_cols"] = sum(c for _, _, c, k in layout.plans
                                if k is None)
        out["L"] = layout.L
        # the operators' gradients: y = Σ_ranks (x · w_s) with x
        # replicated; the gathered w in a replicated use (the same term
        # on every rank: Σ w_1) and in a partial one (rank s adds
        # (s + 1)·Σ w_s, the group's terms summed)
        x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
        w = torch.full((3,), float(s + 1)).requires_grad_(True)
        y = sharding.reduce_from_model(sharding.copy_to_model(x) * w)
        g1 = sharding.gather_tile(w[None] * 1.0, 0, same_grad=True)
        g2 = sharding.gather_tile(w[None] * 1.0, 0)
        (y.sum() + (g1 * torch.arange(2.0)[:, None]).sum()
         + g2[s].sum() * (s + 1)).backward()
        out["op_grads"] = (y.detach(), x.grad, w.grad)
        out["remat_thread"] = _remat_backward_on_another_thread(mesh)
    return out


def _remat_backward_on_another_thread(mesh):
    """A checkpoint region recomputes its forward in the backward pass,
    which the autograd engine runs on its own thread for CUDA tensors,
    where no mesh is active: the split gradient taken on another thread
    equals the one taken on this thread, bit for bit."""
    cfg = dataclasses.replace(configs.get("gemma-2b", smoke=True),
                              dtype="float32", param_dtype="float32",
                              remat=True, attn_direct_max=16)
    model = zoo_model(cfg, seq_len=8)
    tiles = sharding.place_params(
        model.init(torch.Generator().manual_seed(0), "cpu"), mesh)
    tok = torch.randint(0, cfg.vocab_size, (2, 9),
                        generator=torch.Generator().manual_seed(1))

    def loss(leaves):
        with torch.enable_grad():
            return model.loss(leaves, tok[:, :8], tok[:, 8])
    got = {}

    def backward(total, leaves):
        got["g"] = torch.autograd.grad(total, list(leaves.values()))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tiles.items()}
    total = loss(leaves)
    t = threading.Thread(target=backward, args=(total, leaves))
    t.start()
    t.join()
    leaves = {k: v.detach().requires_grad_(True) for k, v in tiles.items()}
    want = torch.autograd.grad(loss(leaves), list(leaves.values()))
    return "g" in got and all(torch.equal(a, b)
                              for a, b in zip(got["g"], want))


def test_gather_unravel_and_the_operators_on_gloo_ranks(tmp_path):
    ranks = spawn_local(_rank, 4, (), timeout=RANK_TIMEOUT, workdir=tmp_path)
    assert [r["s"] for r in ranks] == [0, 1, 0, 1]
    # one process: y = x·w_0 + x·w_1 with w_s = s + 1, Σ w_1 once, and
    # Σ_s (s + 1)·Σ w_s
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    ws = [torch.full((3,), float(s + 1)).requires_grad_(True)
          for s in range(2)]
    y = x * ws[0] + x * ws[1]
    (y.sum() + ws[1].sum() + ws[0].sum() + 2 * ws[1].sum()).backward()
    for r in ranks:
        assert r["n_tiled"] > 0 and r["round_trip"]
        # one all_gather a tiled leaf, nothing else
        assert r["gather_counts"] == {"all_reduce": 0,
                                      "all_gather": r["n_tiled"]}
        assert r["gather_recs"] == r["n_tiled"]
        assert r["refused"] and "this rank's tile" in r["refused"]
        assert r["unravel_local"]
        # only the whole leaves' bands cross the group, in one gather
        assert r["unravel_recs"] == [("all-gather", (r["whole_cols"],))]
        assert 0 < r["whole_cols"] < r["L"]
        yv, gx, gw = r["op_grads"]
        assert torch.equal(yv, y.detach())
        assert torch.equal(gx, x.grad)
        assert torch.equal(gw, ws[r["s"]].grad)
        assert r["remat_thread"]


def test_the_layout_is_built_from_whole_shapes():
    """Meta leaves give the same layout as real ones, and a rank's row
    width times ms covers the whole leaves plus their padding."""
    p = _params("gemma-2b")
    meta = {k: torch.empty(v.shape, device="meta") for k, v in p.items()}
    a, b = sharding.blocked_layout(p, 2), sharding.blocked_layout(meta, 2)
    assert a.plans == b.plans and (a.L, a.D) == (b.L, b.D)
    pad = sum(c * 2 - sz for _, sz, c, k in a.plans if k is None)
    assert a.L * 2 == a.D + pad
    assert math.prod((1, a.L)) == a.L
