"""The program's flight recorder reaches the readers: a traced window
hands them the events and spans the program records inside it, each
with its segment and round, and nothing recorded before it."""
import pytest

from bench.harness import fl
from bench.harness import trace as tr
from bench.tests._tiny import tiny


def read_probes(trace, ctx):
    """A reader of a program counter: the probes' ``n`` summed."""
    got = [e.meta["n"] for e in trace.events if e.kind == "probe"]
    return sum(got) if got else None


@pytest.mark.parametrize("name", ["mlp3-xdevice", "mlp3-xdevice-int8"])
def test_a_reader_sees_the_windows_events_alone(name, monkeypatch):
    from repro_torch.fl import telemetry
    cell = tiny(name)
    run = fl.FLCell(cell, 11, "cpu")
    with telemetry.recording():
        telemetry.event("probe", n=100)          # before the window
        run.setup()
    real = fl.FLCell.segment

    def segment(self):
        telemetry.event("probe", n=1)
        real(self)
    monkeypatch.setattr(fl.FLCell, "segment", segment)
    segments = 3
    trace, _ = run.traced_window(segments)
    T = cell.traffic["eval_every"]
    assert read_probes(trace, {}) == segments
    probes = [e for e in trace.events if e.kind == "probe"]
    assert [(e.segment, e.round) for e in probes] == \
        [(s, (s + 1) * T) for s in range(segments)]
    # the program's own sync event, one a segment, after its probe
    syncs = [e for e in trace.events if e.kind == "sync"]
    assert [e.segment for e in syncs] == list(range(segments))
    assert all(e.type == "event" and e.meta["leaves"] > 0 for e in syncs)
    assert not telemetry.enabled()


def test_records_fall_in_the_segment_that_holds_them():
    recs = [{"type": "event", "kind": "a", "t": 0.1},
            {"type": "span", "name": "b", "t0": 0.1, "t1": 0.2},
            {"type": "event", "kind": "c", "t": 0.3, "x": 1},
            {"type": "event", "kind": "late", "t": 0.4}]
    got = tr.recorded(recs, [2, 3], every=5)
    assert [(e.kind, e.type, e.segment, e.round) for e in got] == \
        [("a", "event", 0, 5), ("b", "span", 0, 5), ("c", "event", 1, 10)]
    assert got[2].meta == {"t": 0.3, "x": 1}


def test_device_ops_belong_to_the_window_by_their_launch():
    """The device's clock runs ahead of or behind the host's: an
    operation launched inside the window counts though its device time
    falls after the window's end, one launched after the window does
    not, though its device time falls before, and one whose launch the
    trace lacks goes by its device time."""
    win = tr.Op(name=tr.WINDOW, ts=100.0, dur=100.0, kind="user_annotation")
    calls = [tr.Op(name="cudaGraphLaunch", ts=150.0, dur=5.0,
                   kind="cuda_runtime", corr=1),
             tr.Op(name="cudaLaunchKernel", ts=201.0, dur=2.0,
                   kind="cuda_runtime", corr=2)]
    late = tr.Op(name="k_late", ts=199.0, dur=3.0, kind="kernel", corr=1)
    after = tr.Op(name="k_after", ts=198.0, dur=1.0, kind="kernel", corr=2)
    mark = tr.Op(name="fl_phase_handoff", ts=196.0, dur=1.0, kind="kernel",
                 corr=1)
    loose = [tr.Op(name="k_in", ts=120.0, dur=1.0, kind="kernel"),
             tr.Op(name="k_out", ts=205.0, dur=1.0, kind="kernel")]
    t = tr.window_of([win] + calls + [late, after, mark] + loose, rounds=1)
    assert [o.name for o in t.kernels] == ["k_late", "k_in"]
    assert [tr.phase_of(o) for o in t.marks] == ["handoff"]
    assert tr.busy_us(t) == 1.0 + 1.0
