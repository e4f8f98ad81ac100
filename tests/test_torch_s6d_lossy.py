"""Lossy codecs on a model axis > 1: the error-feedback residual plane on
the blocked rows, over gloo ranks, against the reference's 4 x 2 mesh.

The reference runs in one subprocess (``run_reference`` of
``test_torch_s6b_layout.py``) on 8 forced host devices: zoo-tiny in fp32
(2 layers, d 32, vocab 64, seq 8; 4 clients, f = 1 under sign_flip,
streaming diversefl with ``stream_shards=1``) for 2 rounds on its 4 x 2
mesh, one ``run_segment`` a round, under ``compression="bf16"`` and, at
``d_model=256`` (D = 558,336, D/2 = 128 x 2,181), ``"int8"``.  At d 32
D/2 = 13,392 is not a multiple of QBLOCK = 128, so the reference refuses
int8 there, and so does the port.  It hands its data, sealed samples,
initial params, minibatch draws, per-round masks, params and final
residual plane over as ``.npz``.  The port runs the same inputs in one
process and in 8 gloo ranks (``launch.mesh.spawn_local``).

Held:
* the port's 4 x 2 runs against the reference's: params within
  1e-5·max|x| + 1e-6 of each leaf, the residual plane (the ranks' (N, L)
  columns side by side, in blocked element order) likewise, masks, C1
  signs, C2 pass/fail, TPR/FPR and accuracy equal.  As in
  ``test_torch_slice3.py``, a codec input that lies at a rounding tie may
  round to neighbouring levels in the two runs (a 1e-7 difference in the
  update): there the residuals may differ by one codec step and the
  params by that step over the round's kept count (6 of 107,136 residual
  entries at bf16, 242 of 2,233,344 at int8);
* bf16 on 4 x 2 against the port's meshless run: masks equal, params
  within the tolerance, each rank's columns within it of the meshless
  plane's row of the blocked layout (bf16 is elementwise, so the layouts
  agree), both up to those steps.  int8 is held against the reference's
  mesh run only: its QBLOCK groups run along L on the mesh and along D
  off it, in both packages, so the two quantise different groups;
* each rank holds an (N, L) residual with ms·L == D; a lossy round issues
  the f32 round's collectives less its non-finite guard's all_reduce (the
  guard runs on lossless streams only); a run makes one ``host_sync``;
  two chained one-round segments equal one two-round segment bitwise,
  and a whole (N, D) plane handed back is cut to the rank's columns;
  ``run_federated_training``'s uplink on 4 x 2 is the reference's
  per-shard price;
* the refusals that stay, from the engine on 4 x 2: a padded leaf under
  bf16 and D/ms off QBLOCK under int8 raise the reference's texts, and
  ``graph=True`` on a mesh of more than one rank raises its reason;
* a lossy sweep group on a 2 x 2 mesh (cells over the data ranks, each
  off-mesh with the meshless carry) is its solo runs, bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData, make_classification
from repro_torch.fl import (Federation, FLConfig, RoundEngine,
                            run_federated_training, softmax_regression,
                            zoo_model)
from repro_torch.fl import simulator as sim
from repro_torch.fl.compression import QBLOCK
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.models import ModelConfig
from repro_torch.optim import constant_lr

WIDTH = {"bf16": 32, "int8": 256}
CFG = dict(n_clients=4, f=1, rounds=2, local_steps=1, batch_size=4, l2=0.0,
           aggregator="diversefl", streaming=True, stream_shards=1,
           eval_every=2, seed=0)
SEQ, LR = 8, 0.05
RANK_TIMEOUT = 180


def tiny(width):
    return dict(name="zoo-tiny", n_layers=2, d_model=width, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=64, attn_direct_max=16)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_LOSSY = """
import jax.numpy as jnp
from repro.core.attacks import AttackConfig
from repro.fl import FLConfig, RoundEngine, make_zoo_federation, zoo_model
from repro.fl.metrics import comm_stats
from repro.launch.mesh import make_host_mesh
from repro.models.config import ModelConfig

mesh = make_host_mesh(data=4, model=2)
for codec, width in (("bf16", 32), ("int8", 256)):
    model = zoo_model(ModelConfig(
        name="zoo-tiny", n_layers=2, d_model=width, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=64, attn_direct_max=16, dtype="float32",
        param_dtype="float32"), seq_len=8)
    cfg = FLConfig(n_clients=4, f=1, rounds=2, local_steps=1, batch_size=4,
                   l2=0.0, aggregator="diversefl", streaming=True,
                   stream_shards=1, eval_every=2, seed=0, compression=codec,
                   attack=AttackConfig(kind="sign_flip"))
    fed = make_zoo_federation(model, cfg, per_client=16, n_test=32)
    p0 = model.init(jax.random.PRNGKey(cfg.seed + 1))
    lrs = jnp.full((1,), 0.05, jnp.float32)
    d, P = fed.data, codec + "_"
    OUT.update({P + "x": np.asarray(d.x), P + "y": np.asarray(d.y),
                P + "n_classes": np.asarray(d.n_classes),
                P + "test_x": np.asarray(fed.test_x),
                P + "test_y": np.asarray(fed.test_y)})
    for j in range(cfg.n_clients):
        sx, sy = fed.server.enclave.unseal_samples(j)
        OUT[f"{P}sx_{j}"], OUT[f"{P}sy_{j}"] = np.asarray(sx), np.asarray(sy)
    for i, leaf in enumerate(jax.tree.leaves(p0)):
        OUT[f"{P}p0_{i:03d}"] = np.asarray(leaf)
    key, idx = jax.random.PRNGKey(cfg.seed), []
    for _ in range(cfg.rounds):
        key, sub = jax.random.split(key)
        kb = jax.random.split(sub, 4)[0]
        idx.append(np.stack([np.asarray(jax.random.randint(
            k, (cfg.batch_size,), 0, d.per_client))
            for k in jax.random.split(kb, cfg.n_clients)]))
    OUT[P + "batch_idx"] = np.stack(idx)
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    carry, key = p0, jax.random.PRNGKey(cfg.seed)
    for r in range(cfg.rounds):
        carry, key, logs = eng.run_segment(carry, key, lrs)
        OUT[f"{P}mask_{r}"] = np.asarray(logs["mask"])
    met = eng.eval_metrics(eng.carry_params(carry), logs)
    for k in ("acc", "c1c2", "mask_tpr", "mask_fpr"):
        OUT[P + k] = np.asarray(met[k])
    for i, leaf in enumerate(jax.tree.leaves(eng.carry_params(carry))):
        OUT[f"{P}p_{i:03d}"] = np.asarray(leaf)
    OUT[P + "resid"] = np.asarray(carry[1])
    D = sum(p.size for p in jax.tree.leaves(p0))
    OUT[P + "uplink"] = np.asarray(comm_stats(
        cfg, D, model_shards=eng.model_shards)["uplink_bytes_per_round"])
    OUT[P + "ms"] = np.asarray(eng.model_shards)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and results (one subprocess per file)."""
    from test_torch_s6b_layout import run_reference
    return run_reference(REF_LOSSY, tmp_path_factory.mktemp("ref"), {},
                         devices=8)


def _setup(ref, codec, compression=None):
    """The port's model, config, federation and initial params on the
    reference's inputs."""
    P = codec + "_"
    model = zoo_model(ModelConfig(**tiny(WIDTH[codec]), dtype="float32",
                                  param_dtype="float32"), seq_len=SEQ)
    cfg = FLConfig(**CFG, compression=compression or codec,
                   attack=AttackConfig(kind="sign_flip"))
    data = FederatedData(torch.from_numpy(ref[P + "x"]).long(),
                         torch.from_numpy(ref[P + "y"]).long(),
                         int(ref[P + "n_classes"]))
    fed = Federation.create(model, data,
                            torch.from_numpy(ref[P + "test_x"]).long(),
                            torch.from_numpy(ref[P + "test_y"]).long(), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    for j in range(cfg.n_clients):
        fed.server.ingest_samples(j, ref[f"{P}sx_{j}"], ref[f"{P}sy_{j}"])
    like = model.init(torch.Generator().manual_seed(0), "cpu")
    p0 = {k: torch.from_numpy(ref[f"{P}p0_{i:03d}"]) for i, k in
          enumerate(like)}
    return model, cfg, fed, p0


def _segments(eng, p0, idx, counts=None, codec_in=None):
    """Two chained one-round segments on the injected draws, each
    round's mask kept; ``counts`` gets the collectives they issued and
    ``codec_in`` each round's codec input u + resid (one block a round)."""
    lrs = torch.full((1,), LR, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    carry, masks = p0, []
    before = sharding.collective_counts()
    real = sim.encode_with_feedback

    def recorded(codec, u, resid):
        codec_in.append(u.to(torch.float32) + resid)
        return real(codec, u, resid)
    if codec_in is not None:
        sim.encode_with_feedback = recorded
    try:
        for r in range(idx.shape[0]):
            carry, logs = eng.run_segment(carry, gen, lrs,
                                          draws={"batch_idx": idx[r:r + 1]})
            masks.append(logs["mask"].clone())
    finally:
        sim.encode_with_feedback = real
    if counts is not None:
        after = sharding.collective_counts()
        counts.update({k: after[k] - before[k] for k in after})
    return carry, logs, masks


def _lossy_run(rank, world, ref, codec, mesh_shape):
    """The port's run of ``codec`` on the reference's inputs: chained
    segments (masks a round, final carry, eval metrics); on a mesh also
    one two-round segment (bitwise the chain), the f32 round's
    collectives, and ``run_federated_training``'s one sync and uplink."""
    model, cfg, fed, p0 = _setup(ref, codec)
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape,
                                                          device="cpu")
    idx = torch.from_numpy(ref[codec + "_batch_idx"]).long()
    eng = RoundEngine(model, fed, cfg, mesh=mesh)
    counts, codec_in = {}, []
    carry, logs, masks = _segments(eng, p0, idx, counts, codec_in)
    met = eng.eval_metrics(eng.carry_params(carry), logs)
    # the carry holds the rank's tiles on a model axis > 1
    out = {"params": eng.whole_params(carry[0]), "resid": carry[1],
           "masks": masks,
           "ms": eng.model_shards, "counts": counts, "v": codec_in,
           **{k: met[k].numpy() for k in ("acc", "c1c2", "mask_tpr",
                                           "mask_fpr")}}
    if mesh is None:
        return out
    one, _ = eng.run_segment(p0, torch.Generator().manual_seed(0),
                             torch.full((2,), LR), draws={"batch_idx": idx})
    out["chained_is_one"] = all(
        torch.equal(one[0][k], carry[0][k]) for k in carry[0]) \
        and torch.equal(one[1], carry[1])
    if codec == "bf16":
        # a whole (N, D) plane in blocked element order is cut to the
        # rank's columns: the next round from it is the next round from
        # the columns
        whole = torch.cat(list(sharding.all_gather(
            carry[1], sharding.model_group(mesh))), dim=1)
        nxt = [eng.run_segment((dict(carry[0]), r.clone()),
                               torch.Generator().manual_seed(1),
                               torch.full((1,), LR),
                               draws={"batch_idx": idx[:1]})[0]
               for r in (whole, carry[1])]
        out["whole_plane_cut"] = (
            tuple(whole.shape) == (4, 2 * carry[1].shape[1])
            and torch.equal(nxt[0][1], nxt[1][1])
            and all(torch.equal(nxt[0][0][k], nxt[1][0][k])
                    for k in carry[0]))
    if codec == "bf16":
        f32 = RoundEngine(model, fed, FLConfig(
            **CFG, compression="f32", attack=AttackConfig(kind="sign_flip")),
            mesh=mesh)
        out["f32_counts"] = {}
        _segments(f32, p0, idx, out["f32_counts"])
    syncs, real = {"n": 0}, sim.host_sync

    def counted(tree):
        syncs["n"] += 1
        return real(tree)
    sim.host_sync = counted
    try:
        h = run_federated_training(model, fed, cfg, constant_lr(LR),
                                   engine=eng)
    finally:
        sim.host_sync = real
    out.update(syncs=syncs["n"], uplink=h["uplink_bytes_per_round"],
               hist_finite=bool(np.isfinite(h["acc"]).all()))
    return out


def _refusals(rank, world):
    """The refusals that stay, from the engine on a 4 x 2 mesh: the
    texts of the ValueError a padded leaf (bf16) and an off-QBLOCK D/ms
    (int8) raise, and of graph=True's NotImplementedError."""
    mesh = make_host_mesh(4, 2, device="cpu")
    out = {}
    # softmax regression over 5 classes: its (5,) bias cannot tile ms = 2
    x, y = make_classification(torch.Generator().manual_seed(0), 64, 5, 8)
    data = FederatedData(x.reshape(4, 16, 8), y.reshape(4, 16), 5)
    smodel = softmax_regression(input_dim=8, n_classes=5)
    zmodel = zoo_model(ModelConfig(**tiny(32), dtype="float32",
                                   param_dtype="float32"), seq_len=SEQ)
    for name, model, codec in (("pad-free", smodel, "bf16"),
                               ("QBLOCK", zmodel, "int8")):
        cfg = FLConfig(**CFG, compression=codec,
                       attack=AttackConfig(kind="sign_flip"))
        if model is smodel:
            fed = Federation.create(model, data, x[:8], y[:8], cfg,
                                    torch.Generator().manual_seed(2),
                                    device="cpu")
        else:
            from repro_torch.fl import make_zoo_federation
            fed = make_zoo_federation(model, cfg, torch.Generator()
                                      .manual_seed(3), per_client=16,
                                      n_test=8, device="cpu")
        params = model.init(torch.Generator().manual_seed(1), "cpu")
        eng = RoundEngine(model, fed, cfg, mesh=mesh)
        try:
            eng.run_segment(params, torch.Generator().manual_seed(0),
                            torch.full((1,), LR))
        except ValueError as exc:
            out[name] = (str(exc), tuple(v.numel() for v in
                                         params.values()))
        else:
            out[name] = None
        if name == "QBLOCK":
            try:
                RoundEngine(model, fed, cfg, mesh=mesh, graph=True)
            except NotImplementedError as exc:
                out["graph"] = str(exc)
    return out


@pytest.fixture(scope="module")
def mesh_runs(ref, tmp_path_factory):
    """Both codecs on 8 gloo ranks (a 4 x 2 mesh), one spawn."""
    return spawn_local(_mesh_main, 8, (ref,), timeout=RANK_TIMEOUT,
                       workdir=tmp_path_factory.mktemp("ranks"))


def _mesh_main(rank, world, ref):
    return {"bf16": _lossy_run(rank, world, ref, "bf16", (4, 2)),
            "int8": _lossy_run(rank, world, ref, "int8", (4, 2)),
            "refusals": _refusals(rank, world)}


def _close(got, want, what):
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                         dtype=np.float64)
    tol = 1e-5 * np.abs(w).max() + 1e-6
    assert g.shape == w.shape and np.abs(g - w).max() <= tol, \
        (what, np.abs(g - w).max(), tol)


def _same_masks(a, b):
    for k in ("mask_tpr", "mask_fpr", "acc"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ca, cb = np.asarray(a["c1c2"]), np.asarray(b["c1c2"])
    np.testing.assert_array_equal(np.sign(ca), np.sign(cb))
    passes = [(np.abs(c) > 0.5) & (np.abs(c) < 2.0) for c in (ca, cb)]
    np.testing.assert_array_equal(*passes)


def _plane(runs, codec, key="resid", r=None):
    """The ranks' (N, L) columns side by side (data rank 0's model ranks,
    which hold what every data rank holds): the (N, D) plane in blocked
    element order.  ``r`` picks round ``r``'s codec input for key "v"."""
    cols = [runs[s][codec][key] for s in range(2)]
    if r is not None:
        cols = [c[r] for c in cols]
    return torch.cat(cols, dim=1)


def _steps(codec, v):
    """The codec's rounding step at each entry of the (N, L) codec input
    ``v`` (one bf16 ulp of |v|; the int8 scale of its QBLOCK group along
    L) and ``v``'s place between two levels, as a fraction of the step
    (a tie at 0.5)."""
    v = v.numpy()
    if codec == "bf16":
        a = np.abs(v).astype(np.float32)
        lo = (a.view(np.int32) & ~0xFFFF).view(np.float32)
        step = (lo.view(np.int32) + 0x10000).view(np.float32) - lo
        return step, (a - lo) / step
    n, L = v.shape
    scale = np.abs(v).reshape(n, L // 128, 128).max(-1) / np.float32(127)
    step = np.repeat(scale, 128, axis=-1)
    t = v / np.where(step > 0, step, 1.0)
    return step, t - np.floor(t)


def _ties(codec, vs, dvs=None):
    """Per round, the codec input's step and where it lies within 1 % of
    a step of a rounding tie, or, given ``dvs`` (per round, how far the
    codec inputs of the two runs compared lie apart), within twice that
    distance: on a model axis > 1 the split computes each update with
    other partial sums than the meshless run (and than the reference's
    GSPMD split), so the two runs' inputs differ by their rounding, not
    by 1e-7 of a step, and straddle a tie that far from it."""
    out = []
    for r, v in enumerate(vs):
        step, frac = _steps(codec, v)
        win = 1e-2 if dvs is None else np.maximum(
            1e-2, 2 * np.abs(dvs[r].numpy()) / np.where(step > 0, step, 1))
        out.append((step, np.abs(frac - 0.5) < win))
    return out


def _params_close(codec, got, want_leaves, vs, masks, what):
    """Params within 1e-5·max|x| + 1e-6 of each leaf, plus at each entry
    the slack that rounding ties of the clients' codec inputs allow (as
    ``test_torch_slice3.py`` gives its params).  A tie of client i in
    round r moves its residual by one step s_r; each later decode of i
    then moves by at most s_r plus that round's step, and moves the
    round's mean by that over the kept count: ``2 · max_t s_t,i ·
    Σ_{t>=r} w_t,i`` with w the round's keep weight.  ``vs`` and
    ``masks`` are the rounds' (N, D) codec inputs in blocked element order
    and keep masks."""
    layout = sharding.blocked_layout(got, 2)
    ties = _ties(codec, vs)
    step = np.maximum.reduce([t[0] for t in ties])
    w = [m.numpy() / max(1, int(m.sum())) for m in masks]
    slack = 0.0
    for r, (_, tie) in enumerate(ties):
        later = sum(w[r:])[:, None]
        slack = slack + (tie * 2 * step * later).sum(0)
    slack = layout.unravel(torch.from_numpy(
        np.asarray(slack, dtype=np.float32).reshape(2, -1)))
    for (k, g), w in zip(got.items(), want_leaves):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        tol = 1e-5 * np.abs(w).max() + 1e-6
        assert g.shape == w.shape and (
            np.abs(g - w) <= tol + slack[k].numpy() * 1.0001).all(), \
            (what, k, np.abs(g - w).max(), tol)


def _resid_close(codec, got, want, vs, what, dvs=None):
    """Residual planes: within 1e-5·max|x| + 1e-6, except at entries
    where a codec input of some round lies within 1 % of a step of a
    rounding tie (or within twice ``dvs``, :func:`_ties`): a small
    difference in the update rounds the two runs' values to neighbouring
    levels there, and their residuals then differ by one step
    (``test_torch_slice3.py``'s boundary steps).  Such entries are rare,
    and each differs by at most one step."""
    g, w = got.numpy().astype(np.float64), want.astype(np.float64)
    assert g.shape == w.shape, what
    tol = 1e-5 * np.abs(w).max() + 1e-6
    off = np.abs(g - w) > tol
    assert off.mean() < 1e-3, (what, int(off.sum()))
    if off.any():
        parts = _ties(codec, vs, dvs)
        step = np.maximum.reduce([p[0] for p in parts])
        tie = np.logical_or.reduce([p[1] for p in parts])
        assert tie[off].all(), (what, "a step away from a rounding tie")
        assert (np.abs(g - w)[off] <= step[off] * 1.0001 + tol).all(), what


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_lossy_model_mesh_agrees_with_the_references(codec, ref, mesh_runs):
    P = codec + "_"
    assert int(ref[P + "ms"]) == 2
    n = len(mesh_runs[0][codec]["params"])
    D = sum(v.numel() for v in mesh_runs[0][codec]["params"].values())
    want = {k: ref[P + k] for k in ("acc", "c1c2", "mask_tpr", "mask_fpr")}
    for rank, r in enumerate(mesh_runs):
        run = r[codec]
        _same_masks(run, want)
        for i in range(2):
            np.testing.assert_array_equal(run["masks"][i].numpy(),
                                          ref[f"{P}mask_{i}"])
        vs = [_plane(mesh_runs, codec, "v", r) for r in range(2)]
        _params_close(codec, run["params"],
                      [ref[f"{P}p_{i:03d}"] for i in range(n)], vs,
                      run["masks"], (codec, rank))
        # the rank's columns: (N, L) with ms·L == D
        assert tuple(run["resid"].shape) == (4, D // 2) and run["ms"] == 2
        s = rank % 2
        assert torch.equal(run["resid"], mesh_runs[s][codec]["resid"])
        assert run["chained_is_one"] and run["syncs"] == 1
        assert run.get("whole_plane_cut", codec == "int8")
        assert run["hist_finite"]
        assert run["uplink"] == int(ref[P + "uplink"])
    # how far the split moved each codec input from the meshless run's
    base = _lossy_run(0, 1, ref, codec, None)
    layout = sharding.blocked_layout(base["params"], 2)
    dvs = [vs[r] - torch.cat([layout.rows(base["v"][r], s)
                              for s in range(2)], dim=1) for r in range(2)]
    _resid_close(codec, _plane(mesh_runs, codec), ref[P + "resid"], vs,
                 (codec, "resid"), dvs)


def test_bf16_model_mesh_agrees_with_the_meshless_run(ref, mesh_runs):
    base = _lossy_run(0, 1, ref, "bf16", None)
    layout = sharding.blocked_layout(base["params"], 2)
    for rank, r in enumerate(mesh_runs):
        run = r["bf16"]
        _same_masks(run, base)
        for a, b in zip(run["masks"], base["masks"]):
            assert torch.equal(a, b)
        vs = [_plane(mesh_runs, "bf16", "v", r) for r in range(2)]
        _params_close("bf16", run["params"],
                      [v.numpy() for v in base["params"].values()], vs,
                      run["masks"], ("meshless", rank))
        dvs = [v - layout.rows(b, rank % 2)
               for v, b in zip(run["v"], base["v"])]
        _resid_close("bf16", run["resid"],
                     layout.rows(base["resid"], rank % 2).numpy(),
                     run["v"], ("resid", rank), dvs)


def _guide_gathers(params, ms=2):
    """The leaves whose tile cuts a QBLOCK group of the whole tensor: an
    int8 guide quantises such a leaf whole, from one ``all_gather`` of the
    tiles (``compression.quantize_tree``)."""
    n = 0
    for k, v in params.items():
        d = sharding.api._model_split(sharding.api._ref_path(k), v.shape, ms)
        if d is not None and \
                (v.shape[d] // ms) * math.prod(v.shape[d + 1:]) % QBLOCK:
            n += 1
    return n


def test_a_lossy_round_adds_no_collective(mesh_runs):
    """Per round the f32 stream issues one all_reduce more than the bf16
    one (its non-finite guard); the residual issues none.  An int8 guide
    adds one all_gather a leaf whose tile cuts a QBLOCK group (one guide
    block a round here)."""
    for r in mesh_runs:
        got, f32 = r["bf16"]["counts"], r["bf16"]["f32_counts"]
        assert got["all_gather"] == f32["all_gather"] > 0
        assert got["all_reduce"] == f32["all_reduce"] - CFG["rounds"] > 0
        n = _guide_gathers(r["int8"]["params"])
        assert n > 0
        assert r["int8"]["counts"] == {
            **got, "all_gather": got["all_gather"] + CFG["rounds"] * n}


def test_the_refusals_that_stay_fire_from_the_engine(mesh_runs):
    from repro.fl import FLConfig as JaxFLConfig
    for r in mesh_runs:
        out = r["refusals"]
        for name, codec in (("pad-free", "bf16"), ("QBLOCK", "int8")):
            text, sizes = out[name]
            with pytest.raises(ValueError) as e:
                JaxFLConfig(**CFG, compression=codec).validate_model_sharding(
                    sum(sizes), 2, leaf_sizes=sizes)
            assert name in text and text == str(e.value)
        assert "graph=True" in out["graph"]
        assert "one rank a card" in out["graph"]
        assert "at least two cards" in out["graph"]


def _sweep_rank(rank, world):
    """A lossy sweep group (bf16, diversefl, four seeds) on a 2 x 2 mesh:
    the cells spread over the data ranks, each run off-mesh with the
    meshless carry."""
    from repro_torch.fl import SweepSpec, run_federated_sweep
    from repro_torch.optim import inv_sqrt_lr
    from test_torch_s6b_stream import _fed
    base = FLConfig(n_clients=8, f=2, rounds=4, batch_size=2, eval_every=2,
                    l2=0.0, compression="bf16", streaming=True,
                    attack=AttackConfig(kind="sign_flip"))
    spec = SweepSpec(base=base, seeds=(0, 1, 2, 3))
    model, fed = _fed(base, n=8)
    mesh = make_host_mesh(2, 2, device="cpu") if world > 1 else None
    with sharding.use_mesh(mesh):
        hists = run_federated_sweep(model, fed, spec, inv_sqrt_lr(0.05))
    solo = []
    if rank == 0:
        for seed in spec.seeds:
            cfg = FLConfig(**{**{f: getattr(base, f) for f in (
                "n_clients", "f", "rounds", "batch_size", "eval_every",
                "l2", "compression", "streaming", "attack")}, "seed": seed})
            solo.append(run_federated_training(model, fed, cfg,
                                               inv_sqrt_lr(0.05)))
    return {"hists": hists, "solo": solo}


def test_lossy_sweep_on_a_model_mesh_is_its_solo_runs(tmp_path):
    ranks = spawn_local(_sweep_rank, 4, (), timeout=RANK_TIMEOUT,
                        workdir=tmp_path)
    solo = ranks[0]["solo"]
    for r in ranks:
        assert len(r["hists"]) == len(solo) == 4
        for got, want in zip(r["hists"], solo):
            for k in ("round", "acc", "mask_tpr", "mask_fpr",
                      "uplink_bytes_per_round"):
                assert got[k] == want[k], k
            assert all(np.array_equal(x, y) for x, y in zip(got["c1c2"],
                                                            want["c1c2"]))
            for k in want["params"]:
                assert torch.equal(got["params"][k], want["params"][k]), k
