"""The phase readers (``bench/metrics/<phase>_ms.py`` over
``bench/metrics/_phases.py``) on synthetic traces, and on a real traced
run of a tiny cell on the CPU, where no mark is launched."""
import time

import pytest

from bench.harness import main as hm, spec
from bench.harness.trace import Op, Trace, busy_intervals
from bench.metrics import _phases
from bench.tests._tiny import CELLS, tiny

PHASES = ("local_sgd", "update_rows", "guides", "aggregate", "eval",
          "handoff")
READERS = spec.metric_readers(
    [spec.Metric(name=f"{p}_ms", unit="ms", better="lower",
                 source="program_span") for p in PHASES])


def mark(phase, ts):
    return Op(name=f"fl_phase_{phase}", ts=ts, dur=1.0, kind="kernel")


def kernel(name, ts, dur):
    return Op(name=name, ts=ts, dur=dur, kind="kernel")


def trace(device, t0=0.0, t1=100.0, rounds=2):
    return Trace(device=device, launches={}, host=[], t0=t0, t1=t1,
                 rounds=rounds)


def read_all(t, ctx=None):
    return {p: READERS[f"{p}_ms"].read(t, ctx or {}) for p in PHASES}


def cycle(t0, step=5.0):
    """One round's four marks, then eval and hand-off, ``step`` apart."""
    return [mark(p, t0 + i * step) for i, p in enumerate(PHASES)]


def test_the_six_phases_tile_the_window():
    ops = cycle(10.0) + cycle(50.0) + [
        kernel("void at::native::elementwise_kernel<128, 2>(int)", 12.0,
               2.0), kernel("similarity_stats_kernel<true>", 61.0, 3.0)]
    t = trace(ops, rounds=4)
    got = read_all(t)
    assert all(v is not None for v in got.values())
    assert sum(got.values()) == pytest.approx(t.window_us / 1e3 / t.rounds)
    # handoff: [35, 50) and [75, 100), and the stretch before the first mark
    assert got["handoff"] == pytest.approx((15 + 25 + 10) / 1e3 / 4)
    assert got["local_sgd"] == pytest.approx(10 / 1e3 / 4)


def test_the_stretch_before_the_first_mark_is_the_handoffs():
    # the window opens on the device's copies in, before the first mark
    ops = [mark("local_sgd", 30.0), mark("aggregate", 50.0),
           mark("eval", 60.0), mark("handoff", 70.0)]
    got = read_all(trace(ops, rounds=1))
    assert got["handoff"] == pytest.approx((30 + 30) / 1e3)
    assert got["local_sgd"] == pytest.approx(20 / 1e3)
    assert got["update_rows"] == 0.0 and got["guides"] == 0.0


def test_a_gap_after_a_mark_counts_to_its_phase():
    # the device idles from the eval mark at 40 to its first kernel at 70
    ops = [mark("local_sgd", 0.0), kernel("k", 1.0, 38.0),
           mark("aggregate", 39.0), mark("eval", 40.0),
           kernel("k", 70.0, 5.0), mark("handoff", 80.0)]
    t = trace(ops, rounds=1)
    assert read_all(t)["eval"] == pytest.approx(40 / 1e3)
    parts, rounds = _phases.split(t)
    assert rounds == 1
    assert parts["eval"]["us"] == pytest.approx(40.0)
    # the kernel's 5 us; the eval mark's own 1 us is no work
    assert parts["eval"]["busy_us"] == pytest.approx(5.0)
    assert parts["eval"]["kernels"] == 1
    assert parts["local_sgd"]["kernels"] == 1


SEGMENT = {
    # the four a round, then the eval point
    "dense": list(PHASES[:4]) * 3 + ["eval", "handoff"],
    # a preamble's local SGD, then the four per fold block
    "streaming": (["local_sgd"] + list(PHASES[:4]) * 2) * 3
    + ["eval", "handoff"],
    # FLTrust: the root update under guides, no guides of its own
    "fltrust-streaming": (["local_sgd", "guides", "local_sgd",
                           "update_rows", "aggregate"]) * 3
    + ["eval", "handoff"],
}


def segments(seq, n, step=1.0, t0=5.0):
    """``n`` segments of the phases ``seq``, ``step`` apart, with the
    window's end one step past the last."""
    ops, t = [], t0
    for _ in range(n):
        for p in seq:
            ops.append(mark(p, t))
            t += step
    return ops, t


@pytest.mark.parametrize("kind", list(SEGMENT))
def test_whole_segments_split_in_order(kind):
    ops, end = segments(SEGMENT[kind], 2)
    t = trace(ops, t1=end, rounds=6)
    got = read_all(t)
    assert read_all(t, {"traffic": {"eval_every": 3}}) == got
    assert sum(got.values()) == pytest.approx(t.window_us / 1e3 / 6)
    seq = SEGMENT[kind]
    assert got["eval"] == pytest.approx(2 / 1e3 / 6)
    assert got["local_sgd"] == pytest.approx(
        2 * seq.count("local_sgd") / 1e3 / 6)


@pytest.mark.parametrize("lost", [1, 2, 7, 13])
@pytest.mark.parametrize("kind", list(SEGMENT))
def test_a_lost_tail_keeps_the_whole_segments(kind, lost):
    # the profile lost the window's last ``lost`` marks: the split keeps
    # the first segment, 3 rounds, and reads it as a one-segment window
    ops, end = segments(SEGMENT[kind], 2)
    ctx = {"traffic": {"eval_every": 3}}
    cut = read_all(trace(ops[:-lost], t1=end, rounds=6), ctx)
    one, end1 = segments(SEGMENT[kind], 1)
    first = read_all(trace(one, t1=end1, rounds=3))
    assert cut == pytest.approx(first)
    assert _phases.split(trace(ops[:-lost], t1=end, rounds=6),
                         ctx)[1] == 3


def test_a_lost_tail_without_a_whole_segment_reads_none():
    ops, end = segments(SEGMENT["dense"], 2)
    ctx = {"traffic": {"eval_every": 3}}
    n = len(SEGMENT["dense"])
    # the first segment's hand-off lost too
    assert set(read_all(trace(ops[:n - 1], t1=end, rounds=6),
                        ctx).values()) == {None}
    # the whole second segment lost: the first's hand-off has no end
    assert set(read_all(trace(ops[:n], t1=end, rounds=6),
                        ctx).values()) == {None}
    # and no eval_every to count the kept segment's rounds by
    assert set(read_all(trace(ops[:-1], t1=end, rounds=6)).values()) \
        == {None}


@pytest.mark.parametrize("drop", [0, 11, 12, 13])
def test_marks_out_of_order_read_none(drop):
    # a mark lost inside the window, here the first segment's first
    # local_sgd, last aggregate, eval or hand-off: no split, rather than
    # a wrong one
    ops, end = segments(SEGMENT["dense"], 2)
    del ops[drop]
    got = read_all(trace(ops, t1=end, rounds=6),
                   {"traffic": {"eval_every": 3}})
    assert set(got.values()) == {None}


def test_no_marks_read_none():
    t = trace([kernel("k", 1.0, 5.0)])
    assert set(read_all(t).values()) == {None}
    assert _phases.split(t) is None
    assert set(read_all(trace([])).values()) == {None}


def test_marks_outside_the_window_are_left_out():
    ops = [mark("handoff", -5.0), mark("local_sgd", 20.0),
           mark("aggregate", 40.0), mark("eval", 60.0),
           mark("handoff", 80.0), mark("local_sgd", 105.0)]
    got = read_all(trace(ops, rounds=1))
    assert got["local_sgd"] == pytest.approx(20 / 1e3)
    assert got["handoff"] == pytest.approx((20 + 20) / 1e3)


@pytest.mark.parametrize("name", CELLS)
def test_a_cpu_traced_run_reports_no_phase(name):
    cell = tiny(name)
    res = hm.run_cell(cell, 2 ** 31 + 5, 0.2, True, "cpu",
                      time.perf_counter())
    assert res["correct"] is True, res["checks"]
    assert not {f"{p}_ms" for p in PHASES} & set(res["metrics"])


def test_a_phases_busy_time_is_the_plain_overlap():
    """Each phase's busy time, taken by bisection over the busy
    intervals, is the plain sum of their overlaps with its stretches."""
    import random
    rnd = random.Random(5)
    ops, t = [], 0.0
    for _ in range(3):
        for p in PHASES:
            ops.append(mark(p, t))
            t += 1.0
            for _ in range(rnd.randrange(0, 6)):
                d = rnd.uniform(0.1, 4.0)
                ops.append(kernel("k", t + rnd.uniform(-2.0, 2.0), d))
                t += rnd.uniform(0.0, 3.0)
    tr = trace(ops, t0=0.0, t1=t + 5.0, rounds=3)
    parts, _ = _phases.split(tr)
    busy = busy_intervals(tr)
    want = {}
    for a, b, p in _phases.intervals(tr)[0]:
        want[p] = want.get(p, 0.0) + sum(
            max(0.0, min(y, b) - max(x, a)) for x, y in busy)
    assert {p: d["busy_us"] for p, d in parts.items()} == \
        pytest.approx(want, abs=1e-9)
