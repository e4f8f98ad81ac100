"""The round's phase marks (``repro_torch.fl.telemetry.phase``) and the
recorder's profiler ranges, on the CPU.

* Under ``torch.profiler`` every run path (the one-sync engine, the
  host-eval loop, the per-round loop) enters the ``fl.<phase>`` ranges in
  ``PHASES`` order every round and every eval segment: dense DiverseFL,
  streaming DiverseFL (the four once per fold block) and FLTrust (its
  root update under ``guides``).
* A phase is no recorder span: the exported record stays the run's own.
* Off the card no mark kernel is launched; on a CUDA device ``phase``
  launches its phase's mark while profiled or captured, and else none.
* A recorder span opens a profiler range of its name while the profiler
  records.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.attacks import AttackConfig
from repro_torch.data import FederatedData, partition_sorted_shards
from repro_torch.fl import (FLConfig, Federation, run_federated_training,
                            softmax_regression, telemetry)
from repro_torch.optim import inv_sqrt_lr

N, DIM, K, PER = 10, 16, 4, 24
LR = inv_sqrt_lr(0.05)
ROUND = ["local_sgd", "update_rows", "guides", "aggregate"]
EDGE = ["eval", "handoff"]
MODES = {"one-sync": {}, "host-eval": {"host_eval": True},
         "per-round": {"use_engine": False}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.default_rng(0)
    centers = np.random.default_rng(77).normal(size=(K, DIM)) * 2.0

    def draw(n):
        y = rng.integers(0, K, size=n)
        x = centers[y] + rng.normal(size=(n, DIM))
        return (torch.from_numpy(x.astype(np.float32)),
                torch.from_numpy(y).long())
    x, y = draw(N * PER)
    tx, ty = draw(60)
    return FederatedData.from_partitions(partition_sorted_shards(x, y, N),
                                         K), tx, ty


def _run(c, mode="one-sync"):
    data, tx, ty = _data()
    model = softmax_regression(input_dim=DIM, n_classes=K)
    fed = Federation.create(model, data, tx, ty, c,
                            torch.Generator().manual_seed(3), device="cpu")
    return run_federated_training(model, fed, c, LR, **MODES[mode])


CASES = {
    "dense-diversefl": (dict(aggregator="diversefl"), ROUND),
    # N = 10 in blocks of 4: three fold blocks, after the preamble's mark
    "streaming-diversefl": (dict(aggregator="diversefl", streaming=True,
                                 client_chunk=4),
                            ["local_sgd"] + ROUND * 3),
    "fltrust": (dict(aggregator="fltrust"), ROUND),
}


def _cfg(**kw):
    return FLConfig(n_clients=N, f=2, rounds=5, eval_every=2, batch_size=4,
                    sample_frac=0.2, attack=AttackConfig(kind="sign_flip"),
                    **kw)


def _phase_ranges(prof):
    """The ``fl.<phase>`` ranges of a profile, in start order."""
    names = {f"fl.{p}": p for p in telemetry.PHASES}
    evs = sorted((e.time_range.start, names[e.name]) for e in prof.events()
                 if e.name in names)
    return [p for _, p in evs]


def _expected(c, per_round):
    out = []
    for r in range(1, c.rounds + 1):
        out += per_round
        if r % c.eval_every == 0 or r == c.rounds:
            out += EDGE
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_phase_ranges_follow_the_cycle(case, mode):
    kw, per_round = CASES[case]
    c = _cfg(**kw)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(c, mode)
    assert _phase_ranges(prof) == _expected(c, per_round)


def test_phases_open_no_recorder_span():
    c = _cfg(**CASES["dense-diversefl"][0])
    with telemetry.recording() as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(c)
    assert _phase_ranges(prof) == _expected(c, ROUND)
    names = {r.get("name") for r in rec.records if r["type"] == "span"}
    assert not names & set(telemetry.PHASES)
    assert not any(str(n).startswith("fl.") for n in names)


def test_marks_launch_on_the_card_where_a_trace_sees_them(monkeypatch):
    calls, capturing = [], [False]
    monkeypatch.setattr(telemetry, "phase_mark_cuda",
                        lambda i, dev: calls.append((i, dev)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    cuda = torch.device("cuda", 0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(_cfg(aggregator="diversefl"))
        assert calls == []
        with telemetry.phase("guides", cuda):
            pass
    # neither profiled nor captured: nothing to see a mark
    with telemetry.phase("guides", cuda):
        pass
    assert calls == [(2, cuda)]
    capturing[0] = True
    with telemetry.phase("handoff", "cuda:0"):
        pass
    assert calls == [(2, cuda), (5, "cuda:0")]
    with pytest.raises(ValueError, match="unknown phase"):
        with telemetry.phase("fold", cuda):
            pass


def test_a_recorder_span_opens_its_range():
    with telemetry.recording() as rec:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i in range(3):
                with telemetry.span(f"probe{i}"):
                    torch.ones(64).sum()
    with telemetry.span("unrecorded"):
        pass
    ranges = [e.name for e in sorted(prof.events(),
                                     key=lambda e: e.time_range.start)
              if e.name.startswith("probe")]
    assert ranges == ["probe0", "probe1", "probe2"]
    assert [r["name"] for r in rec.records] == ranges
