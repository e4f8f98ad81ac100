"""The client step's row writer (``core.diversefl.write_update_rows`` over
``kernels.ops.client_step_rows``) against the arithmetic it replaced.

The unfused step, as the round ran it before: the shared params expanded
to the clients, the model's gradient with the ridge term in autograd,
``sgd_round_once``, the difference from the start, ``flatten_updates``;
blocks of ``chunk`` clients through ``chunked_vmap``.  The row writer
takes the data loss's gradient alone and adds ``l2·θ`` in the step.

Held (every case on the CPU, where ``client_step_rows`` runs its plain
version, the CUDA kernel's arithmetic operation for operation):

* fp32, l2 0 or 5e-4, E 1 or 2, the 3-NN, softmax regression and the
  small CNN at tiny widths, 70 clients in blocks of 16 (a ragged last
  block of 6): the rows are bitwise the unfused ones.  Autograd's ridge
  gradient is ``c·p + c·p`` with ``c = fp32(0.5·l2)``, which is exactly
  ``fp32(l2)·p`` rounded once, and it meets the data gradient in one
  addition, which commutes: the same bits.
* bf16 params, l2 = 0: bitwise.  bf16 with l2 = 5e-4: the unfused step
  rounds the ridge gradient and its sum with the data gradient to bf16,
  the row writer keeps them in fp32 (bitwise the unfused steps with the
  ridge added in fp32).  Against autograd's bf16 ridge one step's θ may
  round to the neighbouring bf16 value: at E = 1 a row is within one bf16
  ulp of the larger of |θ0| and |θ1| (asserted; 0.7-1.6 % of the entries
  differ).  At E = 2 that ulp moves the second step's gradient (a ReLU or
  max-pool kink), so only the fp32-ridge identity is asserted.
* A whole round, dense and streaming, f32 and int8 codecs, diversefl and
  fltrust (the root update), E 1 and 2, 70 clients in blocks of 16: the
  params and every log bitwise the round run with the unfused step.
* On the benchmark cell's traffic at tiny width every update and guide
  row of a round is written through ``ops.client_step_rows`` (on the card
  one kernel launch a block, counted in ``ops.KERNELS``), and so are a
  zoo model's, whatever its config's ``use_kernels`` says (the switch
  guards the kernels that would need a backward; the client step runs
  outside autograd).  Under the int8 codec the guides are quantised in
  place on each leaf's columns: bitwise the unfused guides quantised per
  tensor.
* ``bench/metrics/client_step_roofline.py`` reads the kernel's launches
  in a trace by symbol against its byte count, and nothing without them.
"""
import math

import pytest
import torch

from repro_torch.core.aggregators import flatten_updates
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.diversefl import sgd_round_once, write_update_rows
from repro_torch.data import FederatedData, partition_sorted_shards
from repro_torch.fl import (FLConfig, Federation, mlp3, small_cnn,
                            softmax_regression, telemetry)
from repro_torch.fl import simulator as sim
from repro_torch.fl.chunking import chunked_rows, chunked_vmap
from repro_torch.fl.compression import get_codec, quantize_tree
from repro_torch.kernels import ops
from repro_torch.kernels.client_step import (client_step_rows_cuda,
                                             client_step_rows_plain)

C, CHUNK, M, LR = 70, 16, 3, 0.05
MODELS = {
    "mlp3": (lambda: mlp3(input_dim=12, hidden=6, n_classes=4), (12,)),
    "softmax": (lambda: softmax_regression(input_dim=12, n_classes=4,
                                           zero_init=False), (12,)),
    "small_cnn": (lambda: small_cnn(n_classes=4), (32, 32, 3)),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unfused_update(model, params, xs, ys, lr, l2, E, ridge="autograd"):
    """The step before the row writer: (c, E, m, ...) batches -> (c, D).
    ``ridge="fp32"``: the ridge gradient ``l2·θ`` added to the data
    gradient in fp32 instead of through autograd in the params' dtype."""
    c = xs.shape[0]
    start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
             for k, v in params.items()}
    theta = start
    for e in range(E):
        b = (xs[:, e], ys[:, e])
        if ridge == "autograd":
            g = model.grad(theta, b, l2)
        else:
            g = {k: v.float() + l2 * theta[k].float()
                 for k, v in model.grad(theta, b, 0.0).items()}
        theta = {k: sgd_round_once(theta[k], lr, g[k]) for k in theta}
    return flatten_updates({k: start[k].float() - theta[k].float()
                            for k in start})[0]


def row_writer(model, params, xs, ys, lr, l2, E, chunk):
    """The dense round's Step 2 now: blocks written into one (C, D)."""
    out = torch.full((xs.shape[0], sum(v.numel() for v in params.values())),
                     float("nan"))

    def block(x, y, row0, rows):
        c = x.shape[0]
        start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                 for k, v in params.items()}
        write_update_rows(out, start, [(x[:, e], y[:, e]) for e in range(E)],
                          lambda p, b: model.grad(p, b, 0.0), lr, l2,
                          clients=c, row0=row0, rows=rows)
    chunked_rows(block, (xs, ys), chunk)
    return out


def draw(name, dtype, n=C, E=1, seed=0):
    make, shape = MODELS[name]
    model = make()
    g = torch.Generator().manual_seed(seed)
    params = {k: (v + 0.1 * torch.randn(v.shape, generator=g)).to(dtype)
              for k, v in model.init(g, "cpu").items()}
    xs = torch.randn((n, E, M) + shape, generator=g).to(dtype)
    ys = torch.randint(0, 4, (n, E, M), generator=g)
    return model, params, xs, ys


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 bits of mantissa), elementwise."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("l2", [0.0, 5e-4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_row_writer_against_the_unfused_step(name, E, dtype, l2):
    model, params, xs, ys = draw(name, dtype, E=E)

    def unfused(ridge):
        return chunked_vmap(lambda x, y: unfused_update(
            model, params, x, y, LR, l2, E, ridge), (xs, ys), CHUNK)
    want = unfused("autograd")
    got = row_writer(model, params, xs, ys, LR, l2, E, CHUNK)
    assert got.shape == want.shape and not got.isnan().any()
    if dtype == torch.float32 or l2 == 0.0:
        assert torch.equal(got, want)
        return
    # bf16 with a ridge: bitwise the unfused steps with the ridge added in
    # fp32; against autograd's bf16 ridge, one step's θ differs by at most
    # one bf16 ulp (of the larger of θ0 and θ1)
    assert torch.equal(got, unfused("fp32"))
    if E == 1:
        th0 = flatten_updates({k: v.unsqueeze(0).float()
                               for k, v in params.items()})[0][0]
        mag = torch.maximum(th0.abs(), (th0 - want).abs())
        assert ((got - want).abs() <= bf16_ulp(mag)).all()


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_client"])
def test_plain_version_writes_only_its_rows(shared, lr_kind):
    """rows row0 .. row0 + rows - 1, leaf by leaf at the flatten_updates
    columns, θp shared (zero stride) or per client; lr a number or a 0-d
    tensor; nothing else of out is touched."""
    g = torch.Generator().manual_seed(5)
    shapes = [(3,), (4, 5), (2,)]
    c, rows, row0 = 6, 4, 3
    grads = [torch.randn((c,) + s, generator=g) for s in shapes]
    t0 = [torch.randn(s, generator=g) for s in shapes]
    th0 = [t.unsqueeze(0).expand((c,) + s) for t, s in zip(t0, shapes)]
    thp = th0 if shared else [t + 0.1 * torch.randn(t.shape, generator=g)
                              for t in th0]
    lr = LR if lr_kind == "float" else torch.tensor(LR)
    out = torch.full((row0 + rows + 2, 3 + 20 + 2), float("nan"))
    client_step_rows_plain(out, grads, th0, thp, lr, 5e-4, row0, rows)
    col = 0
    for gk, ak, pk in zip(grads, th0, thp):
        n = gk[0].numel()
        p = pk.reshape(c, -1)[:rows]
        want = ak.reshape(c, -1)[:rows] - (
            p - lr * (gk.reshape(c, -1)[:rows] + 5e-4 * p))
        assert torch.equal(out[row0:row0 + rows, col:col + n], want)
        col += n
    assert out[:row0].isnan().all() and out[row0 + rows:].isnan().all()


def test_cuda_wrapper_refuses_before_launch():
    x = [torch.zeros((2, 3))]
    with pytest.raises(ValueError, match="CUDA fp32"):
        client_step_rows_cuda(torch.zeros((2, 3)), x, x, x, LR, 0.0)
    # the op routes a CPU out to the plain version
    out = torch.zeros((2, 3))
    assert ops.client_step_rows(out, x, x, x, LR, 0.0) is out


# ----------------------------------------------------------------------
# whole rounds: the row writer against the unfused step
# ----------------------------------------------------------------------

def unfused_writer(model):
    """``write_update_rows`` by the unfused arithmetic for ``model``: the
    ridge goes back into autograd (the ``grad_fn`` the round passes is
    the data loss's alone)."""
    def write(out, params, batches, grad_fn, lr, l2=0.0, *, clients,
              row0=0, rows=None):
        theta = params
        for b in batches:
            g = model.grad(theta, b, l2)
            theta = {k: sgd_round_once(theta[k], lr, g[k]) for k in theta}
        upd = flatten_updates({k: params[k].float() - theta[k].float()
                               for k in params})[0].reshape(clients, -1)
        n = clients if rows is None else rows
        out[row0:row0 + n] = upd[:n]
        return out
    return write


def federation(cfg, seed=0):
    model = mlp3(input_dim=12, hidden=6, n_classes=4)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((cfg.n_clients * 8, 12), generator=g)
    y = torch.randint(0, 4, (cfg.n_clients * 8,), generator=g)
    data = FederatedData.from_partitions(
        partition_sorted_shards(x, y, cfg.n_clients), 4)
    fed = Federation.create(model, data, x[:40], y[:40], cfg,
                            torch.Generator().manual_seed(3), device="cpu")
    return model, fed


def run_rounds(cfg, unfused, monkeypatch):
    model, fed = federation(cfg)
    if unfused:
        from repro_torch.fl import server
        monkeypatch.setattr(sim, "write_update_rows", unfused_writer(model))
        monkeypatch.setattr(server, "write_update_rows",
                            unfused_writer(model))
    body = sim.make_round_body(model, fed, cfg)
    carry = model.init(torch.Generator().manual_seed(1), "cpu")
    if body.lossy:
        d = sum(v.numel() for v in carry.values())
        carry = (carry, torch.zeros((cfg.n_clients, d)))
    gen, logs = torch.Generator().manual_seed(7), []
    for _ in range(2):
        carry, lg = body(carry, torch.tensor(LR), gen)
        logs.append(lg)
    monkeypatch.undo()
    return carry, logs, body


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("E", [1, 2])
@pytest.mark.parametrize("agg,codec,streaming", [
    ("diversefl", "f32", False), ("diversefl", "f32", True),
    ("diversefl", "int8", False), ("diversefl", "int8", True),
    ("fltrust", "f32", False)])
def test_round_matches_the_unfused_step(agg, codec, streaming, E,
                                        monkeypatch):
    cfg = FLConfig(n_clients=C, f=14, rounds=2, eval_every=2, batch_size=M,
                   local_steps=E, l2=5e-4, sample_frac=0.2, aggregator=agg,
                   attack=AttackConfig(kind="sign_flip"), compression=codec,
                   streaming=streaming, client_chunk=CHUNK)
    got, got_logs, body = run_rounds(cfg, False, monkeypatch)
    want, want_logs, _ = run_rounds(cfg, True, monkeypatch)
    assert same(got, want) and same(got_logs, want_logs)


# ----------------------------------------------------------------------
# the engagement record
# ----------------------------------------------------------------------

def step_calls(monkeypatch):
    """Record each ``ops.client_step_rows`` call's (row0, rows) and the
    params' dtype; the calls still run."""
    calls, op = [], ops.client_step_rows

    def counted(out, grads, theta0, thetap, lr, l2=0.0, row0=0, rows=None):
        calls.append((row0, grads[0].shape[0] if rows is None else rows,
                      grads[0].dtype))
        return op(out, grads, theta0, thetap, lr, l2, row0, rows)
    monkeypatch.setattr(ops, "client_step_rows", counted)
    return calls


def test_the_cell_traffic_runs_fused(monkeypatch):
    """mlp3-xdevice's traffic (bench/traffic/xdevice-1024.json) at tiny
    width: diversefl, sign flip, f = 20 %, batch 10, E = 1, l2 5e-4, dense
    f32 in blocks of 16 of 64 clients.  Each block of Step 2 and of the
    guides is one ``client_step_rows`` call on its rows: 8 a round."""
    cfg = FLConfig(n_clients=64, f=13, rounds=1, eval_every=1, batch_size=10,
                   l2=5e-4, sample_frac=0.1, aggregator="diversefl",
                   attack=AttackConfig(kind="sign_flip"), client_chunk=16)
    model, fed = federation(cfg)
    body = sim.make_round_body(model, fed, cfg)
    assert body.streaming_fallback is None
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    calls = step_calls(monkeypatch)
    new, logs = body(params, torch.tensor(0.05), torch.Generator())
    blocks = [(r0, 16, torch.float32) for r0 in range(0, 64, 16)]
    assert calls == blocks * 2
    assert all(torch.isfinite(v).all() for v in new.values())
    assert logs["mask"].shape == (64,)


def test_lossy_guides_are_quantised_in_place():
    """int8: the guide rows quantised on each leaf's columns equal the
    unfused guides quantised per tensor, bit for bit; no fallback."""
    cfg = FLConfig(n_clients=C, f=14, rounds=1, eval_every=1, batch_size=M,
                   l2=5e-4, sample_frac=0.2, compression="int8",
                   client_chunk=CHUNK)
    model, fed = federation(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    codec = get_codec("int8")
    got = fed.server.compute_guides(
        params, lambda p, b: model.grad(p, b, 0.0), LR, 1,
        client_chunk=CHUNK, codec=codec, l2=5e-4)
    gx, gy = fed.server.guide_batches()

    def unfused(x, y):
        c = x.shape[0]
        start = {k: v.unsqueeze(0).expand((c,) + tuple(v.shape))
                 for k, v in params.items()}
        g = model.grad(start, (x, y), 5e-4)
        guides = {k: start[k].float() - sgd_round_once(start[k], LR,
                                                       g[k]).float()
                  for k in start}
        return flatten_updates(quantize_tree(codec, guides))[0]
    assert torch.equal(got, chunked_vmap(unfused, (gx, gy), CHUNK))


def test_a_zoo_client_step_takes_the_op_whatever_use_kernels(monkeypatch):
    """A bf16 zoo model whose config leaves ``use_kernels`` off: its
    update and guide rows go through ``client_step_rows`` all the same,
    one client a call."""
    from repro_torch.fl import make_zoo_federation, zoo_model
    from repro_torch.models import ModelConfig
    m = zoo_model(ModelConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                              n_kv_heads=1, d_ff=32, vocab_size=32,
                              attn_direct_max=16), seq_len=8)
    cfg = FLConfig(n_clients=2, f=0, rounds=1, batch_size=2, l2=0.0,
                   eval_every=1, attack=AttackConfig(kind="none"))
    fed = make_zoo_federation(m, cfg, per_client=4, n_test=4, device="cpu")
    body = sim.make_round_body(m, fed, cfg)
    assert not m.cfg.use_kernels
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    calls = step_calls(monkeypatch)
    body(params, torch.tensor(0.05), torch.Generator())
    dt = next(iter(params.values())).dtype
    assert calls == [(0, 2, dt)] * 2


# ----------------------------------------------------------------------
# bench/metrics/client_step_roofline.py
# ----------------------------------------------------------------------

def test_roofline_reader_counts_the_round_bytes():
    from bench.harness import spec
    from bench.harness.trace import Op, Trace
    reader = spec.metric_readers([spec.Metric(
        name="client_step_roofline", unit="%", better="higher",
        source="device_trace")])["client_step_roofline"]
    traffic = {"n_clients": 1024, "client_chunk": 64, "local_steps": 1}
    ctx, d = {"traffic": traffic, "d": 199_210}, 199_210
    least_s = 2 * (2 * 1024 * d * 4 + 16 * d * 4) / 3.35e12
    assert least_s == pytest.approx(0.982e-3, rel=1e-3)
    ops_ = [Op(name="void (anonymous namespace)::client_step_rows_kernel"
               "<float>((anonymous namespace)::Args)", ts=10.0 * i, dur=40.0,
               kind="kernel") for i in range(32)]
    ops_.append(Op(name="similarity_stats_kernel<true>", ts=400.0, dur=9.0,
                   kind="kernel"))
    t = Trace(device=ops_, launches={}, host=[], t0=0.0, t1=500.0, rounds=1)
    assert reader.read(t, ctx) == pytest.approx(
        100 * least_s / (32 * 40e-6))
    none = Trace(device=ops_[-1:], launches={}, host=[], t0=0.0, t1=500.0,
                 rounds=1)
    assert reader.read(none, ctx) is None
    assert math.isclose(
        reader.round_bytes({**traffic, "local_steps": 2}, d),
        2 * (3 * 1024 * d * 4 + 16 * d * 4))
