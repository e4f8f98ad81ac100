"""The traced run's device timeline, from ``torch.profiler``.

``profiled()`` records CPU and CUDA activity; :func:`read` turns the
profiler's events into a :class:`Trace`: the device's operations
(kernels, copies, sets), the runtime calls that launched them (matched by
correlation id), the host's ranges and operators, and the window, the
``bench.window`` range the harness places around the profiled segments.
Times are in microseconds on the profiler's one clock.

The program's phase marks (the empty kernels ``fl_phase_<phase>``) are
device operations of the trace, but no work: :attr:`Trace.marks` holds
them, and the kernel count, the busy time and the breakdown leave them
out.  :attr:`Trace.events` holds what the program's flight recorder
(``repro_torch.fl.telemetry``) recorded in the window: its events and
spans, each with the segment and round it fell in.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch

WINDOW = "bench.window"
MARK = re.compile(r"^fl_phase_(\w+)$")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver",
              "python_function")


@dataclasses.dataclass
class Op:
    name: str
    ts: float           # start, us
    dur: float          # us
    kind: str
    corr: int = 0

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Event:
    """One record of the program's flight recorder in the traced window:
    ``type`` ``"event"`` (``kind`` its kind) or ``"span"`` (``kind`` its
    name), ``meta`` its other fields, and where it fell: the window's
    ``segment`` (0-based) and ``round``, the 1-based window round that
    closes that segment (the host sees a segment's rounds as one
    dispatch and one sync)."""
    type: str
    kind: str
    meta: dict
    segment: int
    round: int


def phase_of(op: Op) -> Optional[str]:
    """The phase a mark kernel enters, None for any other operation."""
    if op.kind != "kernel" or not op.name.startswith("fl_phase_"):
        return None
    m = MARK.match(_short(op.name))
    return m.group(1) if m else None


@dataclasses.dataclass
class Trace:
    device: List[Op]            # kernels, copies and sets in the window
    launches: dict              # correlation id -> the launching call
    host: List[Op]              # ranges, operators and runtime calls
    t0: float
    t1: float
    rounds: int
    events: List[Event] = dataclasses.field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def marks(self) -> List[Op]:
        """The phase marks among the device operations."""
        return [o for o in self.device if phase_of(o)]

    @property
    def work(self) -> List[Op]:
        """The device operations that are not marks."""
        return [o for o in self.device if not phase_of(o)]

    @property
    def kernels(self) -> List[Op]:
        """The kernels that are not marks."""
        return [o for o in self.work if o.kind == "kernel"]

    def ranges(self, name: str) -> List[Op]:
        return [o for o in self.host if o.kind == "user_annotation"
                and o.name == name]


def profiled(device):
    """A profiler of host activity and, on the card, device activity."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _events(prof):
    """The profiler's events, from its Chrome trace (written to a
    temporary file and read back)."""
    import json
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        yield Op(name=e.get("name", ""), ts=float(e["ts"]),
                 dur=float(e.get("dur", 0.0)), kind=e.get("cat", ""),
                 corr=int(args.get("correlation", -1)))


def recorded(records: List[dict], ends: List[int], every: int
             ) -> List[Event]:
    """The flight recorder's ``records`` of the window as events: record
    i fell in the first segment s whose record count at its end,
    ``ends[s]``, exceeds i."""
    out, s = [], 0
    for i, r in enumerate(records):
        while s < len(ends) and i >= ends[s]:
            s += 1
        if s == len(ends):
            break
        kind = r["kind"] if r["type"] == "event" else r["name"]
        meta = {k: v for k, v in r.items()
                if k not in ("type", "kind", "name")}
        out.append(Event(type=r["type"], kind=kind, meta=meta, segment=s,
                         round=(s + 1) * every))
    return out


def read(prof, rounds: int, events: Optional[List[Event]] = None) -> Trace:
    """The profiled window's trace (:func:`window_of` the profiler's
    events) with the program's recorded ``events``."""
    return window_of(list(_events(prof)), rounds, events)


def window_of(ops: List[Op], rounds: int,
              events: Optional[List[Event]] = None) -> Trace:
    """The ``bench.window`` range's trace: the device operations launched
    inside it, host events that overlap it.  A device operation belongs
    to the window by the host call that launched it (matched by
    correlation id; a graph's kernels by its launch), not by its device
    time: the device's clock and the host's can disagree by tens of
    microseconds, which would cut the window's last operations or take
    in the first ones launched after it.  An operation whose launch the
    trace lacks is placed by its device time."""
    wins = [o for o in ops if o.kind == "user_annotation"
            and o.name == WINDOW]
    if not wins:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    t0, t1 = wins[0].ts, wins[0].end
    launches = {o.corr: o for o in ops
                if o.kind in ("cuda_runtime", "cuda_driver") and o.corr >= 0}

    def inside(o):
        call = launches.get(o.corr)
        if call is not None:
            return t0 <= call.ts < t1
        return o.end > t0 and o.ts < t1
    device = [o for o in ops if o.kind in DEVICE_KINDS and inside(o)]
    host = [o for o in ops if o.kind in HOST_KINDS
            and o.end > t0 and o.ts < t1]
    return Trace(device=device, launches=launches, host=host, t0=t0, t1=t1,
                 rounds=rounds, events=list(events or []))


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals within the window,
    marks left out."""
    spans = sorted((max(o.ts, trace.t0), min(o.end, trace.t1))
                   for o in trace.work)
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches in which no device operation runs."""
    gaps, t = [], trace.t0
    for a, b in busy_intervals(trace):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        gaps.append((t, trace.t1))
    return gaps


def _short(name: str, n: int = 120) -> str:
    """A kernel's name without its trailing argument list, cut to ``n``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name if len(name) <= n else name[:n]


def host_activity(trace: Trace, t: float) -> Optional[str]:
    """The innermost host event running at time ``t``."""
    live = [o for o in trace.host if o.ts <= t < o.end]
    if not live:
        return None
    return _short(min(live, key=lambda o: o.dur).name)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing as each began."""
    by_name: dict = {}
    for o in trace.work:
        k = _short(o.name)
        by_name[k] = by_name.get(k, 0.0) + (min(o.end, trace.t1)
                                            - max(o.ts, trace.t0))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in ops],
            "idle_gaps": [[host_activity(trace, a) or "no host event",
                           (b - a) / 1e6] for a, b in gaps]}


def launched_within(trace: Trace, name: str) -> List[Op]:
    """Kernels whose launching call lies inside a host range ``name`` (on
    any thread)."""
    spans = [(r.ts, r.end) for r in trace.ranges(name)]
    if not spans:
        return []
    out = []
    for k in trace.kernels:
        call = trace.launches.get(k.corr)
        if call is not None and any(a <= call.ts <= b for a, b in spans):
            out.append(k)
    return out
