"""A split round's minibatch stacks (``FederatedData.segment_minibatches``
with ``rows``), the one rule that decides the split
(``sharding.client_split``), and the streaming fold on rank-row stacks.

* ``segment_minibatches(rows=(lo, hi))`` returns rows ``[lo, hi)`` of the
  whole stacks bit for bit, and leaves the generator where the whole draw
  leaves it; ``client_minibatch`` is the same rows of ``minibatch``.
* ``client_split`` on stand-in meshes: a split needs R > 1 data ranks, a
  model axis of 1 and R | n; a streaming fold also needs R | groups and
  blocks with no padding row.  ``stream_aggregate`` refuses rank rows
  that are not the blocks it folds.
* On 4 gloo data ranks (one ``spawn_local`` for the file): a streaming
  round on rank-row stacks is the one-process ``stream_shards=4`` fold,
  bitwise, and each rank's stacks hold its N/4 rows; where the fold does
  not spread (``stream_shards=2``), where padding rows would cross ranks
  (blocks of 5) and for an async round, the stacks are whole and the
  fold is the one-process fold as before.  Off the mesh the stacks are
  whole.
"""
import types

import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import (FederatedData, make_classification,
                              partition_sorted_shards)
from repro_torch.fl import (Federation, FLConfig, RoundEngine,
                            softmax_regression, stream_aggregate,
                            weighted_mean_rule)
from repro_torch.fl.faults import FaultConfig
from repro_torch.launch.mesh import make_host_mesh, spawn_local

N, DIM, NC, T, M = 16, 8, 4, 3, 5
RANK_TIMEOUT = 120

# (aggregator, codec, attack, client_chunk, stream_shards, split)
STREAM = [
    ("diversefl", "f32", "sign_flip", 4, None, True),
    ("diversefl", "int8", "sign_flip", 2, None, True),
    ("mean", "bf16", "gaussian", 4, None, True),
    ("fltrust", "f32", "sign_flip", 4, None, True),
    ("oracle", "f32", "sign_flip", 4, 2, False),     # 2 groups, 4 ranks
    ("diversefl", "f32", "sign_flip", 5, None, False),  # a padded block
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=N):
    x, y = make_classification(torch.Generator().manual_seed(0), n * 8, NC,
                               DIM)
    return FederatedData.from_partitions(partition_sorted_shards(x, y, n),
                                         NC)


# ----------------------------------------------------------------------
# the stacks, in one process
# ----------------------------------------------------------------------

@pytest.mark.parametrize("R,r", [(2, 0), (2, 1), (4, 0), (4, 3)])
def test_rank_rows_are_the_whole_stacks_rows(R, r):
    d = _data()
    lo, hi = r * N // R, (r + 1) * N // R
    g_whole, g_rows = (torch.Generator().manual_seed(5) for _ in range(2))
    xw, yw = d.segment_minibatches(T, M, g_whole)
    xr, yr = d.segment_minibatches(T, M, g_rows, rows=(lo, hi))
    assert xr.shape == (T, hi - lo, M, DIM) and yr.shape == (T, hi - lo, M)
    assert torch.equal(xr, xw[:, lo:hi]) and torch.equal(yr, yw[:, lo:hi])
    # the whole (T, N, m) draw was made: the generators are in step
    assert torch.equal(g_rows.get_state(), g_whole.get_state())
    idx = torch.randint(0, d.per_client, (T, N, M),
                        generator=torch.Generator().manual_seed(6))
    xi, _ = d.segment_minibatches(T, M, idx=idx, rows=(lo, hi))
    assert torch.equal(xi, d.segment_minibatches(T, M, idx=idx)[0][:, lo:hi])
    # inline: one round's rows of the selected clients
    sel = torch.randperm(N, generator=torch.Generator().manual_seed(7))
    xb, yb = d.minibatch(M, idx=idx[0])
    xs, ys = d.client_minibatch(idx[0], sel[lo:hi])
    assert torch.equal(xs, xb[sel[lo:hi]]) and torch.equal(ys,
                                                          yb[sel[lo:hi]])


def _stand_in(shape, names=("data", "model"), coord=None):
    """A mesh's geometry without a process group: what the split rule
    reads (axis names, sizes, this rank's coordinate)."""
    coord = coord or [0] * len(shape)
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape,
                                 get_coordinate=lambda: coord)


SPLITS = [
    # (mesh shape, names, coord, n, chunk, groups, want)
    (None, None, None, 16, None, None, None),
    ((1, 1), None, None, 16, None, None, None),
    ((2, 1), None, [1, 0], 16, None, None, (8, 16)),
    ((2, 2), None, [1, 0], 16, None, None, None),       # model axis > 1
    ((2, 1), None, [1, 0], 23, None, None, None),       # 2 does not tile
    ((4, 1), None, [2, 0], 16, 4, 4, (8, 12)),          # streaming, split
    ((4, 1), None, [2, 0], 16, 4, 2, None),             # 2 fold groups
    ((4, 1), None, [2, 0], 16, 5, 4, None),             # a padded block
    ((2, 2, 1), ("pod", "data", "model"), [1, 0, 0], 16, None, None,
     (8, 12)),                                          # pod-major
]


@pytest.mark.parametrize("case", SPLITS, ids=lambda c: f"{c[0]}-{c[3]}-"
                         f"{c[4]}-{c[5]}")
def test_client_split_rule(case):
    shape, names, coord, n, chunk, groups, want = case
    mesh = None if shape is None else _stand_in(
        shape, names or ("data", "model"), coord)
    assert sharding.client_split(n, mesh, chunk=chunk, groups=groups) == want


def test_stream_aggregate_refuses_rows_it_does_not_fold():
    """2 data ranks, one fold group: the fold does not spread, so rank
    rows cannot be its blocks."""
    rule = weighted_mean_rule(lambda u, ci: (torch.ones(u.shape[:-1]),)
                              * 2 + ({},))
    rows = torch.zeros((4, 3))
    with sharding.use_mesh(_stand_in((2, 1), coord=[0, 0])):
        with pytest.raises(ValueError, match="rank rows need a split fold"):
            stream_aggregate(rule, lambda blk, v: (blk[0], {}), (rows,), 4,
                             d=3, shards=1, clients=8)


# ----------------------------------------------------------------------
# the streaming round on rank-row stacks, over 4 gloo ranks
# ----------------------------------------------------------------------

def _stream_round(case, mesh, async_round=False):
    """Two rounds of ``case``; (flat params, logs, resid, stack rows)."""
    agg, codec, attack, chunk, shards, _ = case
    kw = dict(fault=FaultConfig(kind="dropout", rate=0.25)) \
        if async_round else {}
    cfg = FLConfig(n_clients=N, f=4, rounds=2, batch_size=2, eval_every=2,
                   l2=0.0, client_chunk=chunk, streaming=True,
                   stream_shards=shards, aggregator=agg, compression=codec,
                   attack=AttackConfig(kind=attack), **kw)
    tx, ty = make_classification(torch.Generator().manual_seed(9), 64, NC,
                                 DIM)
    model = softmax_regression(input_dim=DIM, n_classes=NC)
    fed = Federation.create(model, _data(), tx, ty, cfg,
                            torch.Generator().manual_seed(2), device="cpu")
    gaussian = attack == "gaussian" or async_round
    eng = RoundEngine(model, fed, cfg, mesh=mesh,
                      batch_mode="inline" if gaussian else "segment")
    built, real = [], fed.data.segment_minibatches

    def stacks(*a, **kw):
        out = real(*a, **kw)
        built.append(int(out[0].shape[1]))
        return out
    fed.data.segment_minibatches = stacks
    p, logs = eng.run_segment(model.init(None, "cpu"),
                              torch.Generator().manual_seed(0),
                              torch.full((2,), 0.05))
    resid = None
    if isinstance(p, tuple):
        p, resid = p[0], (p[1] if codec != "f32" else None)
    with sharding.use_mesh(mesh):
        rows = eng._body.client_rows()
    return (torch.cat([v.reshape(-1) for v in p.values()]), logs, resid,
            built, rows)


def _stream_ranks(rank, world):
    mesh = make_host_mesh(world, 1, device="cpu")
    out = [_stream_round(c, mesh) for c in STREAM]
    out.append(_stream_round(STREAM[0], mesh, async_round=True))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_local(_stream_ranks, 4, (), timeout=RANK_TIMEOUT,
                       workdir=tmp_path_factory.mktemp("ranks"))


def _same(got, want):
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    if want[2] is None:
        assert got[2] is None
    else:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("i", range(len(STREAM) + 1),
                         ids=["-".join(map(str, c[:5])) for c in STREAM]
                         + ["async"])
def test_streaming_on_rank_rows_is_the_one_process_fold(ranks, i):
    case = STREAM[min(i, len(STREAM) - 1)] if i < len(STREAM) \
        else STREAM[0]
    async_round = i == len(STREAM)
    split = case[5] and not async_round
    one_case = case[:4] + (case[4] if case[4] is not None else 4,) \
        + case[5:]
    want = _stream_round(one_case, None, async_round)
    # off the mesh: whole stacks (none drawn ahead in inline mode)
    assert want[4] is None and want[3] in ([], [N])
    for r, got in enumerate(x[i] for x in ranks):
        _same(got, want)
        if split:
            assert got[4] == (r * N // 4, (r + 1) * N // 4)
        else:
            assert got[4] is None
        if got[3]:                     # segment mode: the stacks' rows
            assert got[3] == [N // 4 if split else N]
