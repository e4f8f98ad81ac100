"""Flight recorder: structured telemetry, round tracing and the
enclave's audit log, in PyTorch.

  * **Spans and events**: a process-wide :class:`Recorder`.
    ``span("dispatch")`` / ``event(...)`` emit structured records
    (monotonic time, kind, static metadata).  Recording is off by
    default, and every instrumented site is one ``enabled`` check.
    While ``torch.profiler`` records, a span also opens a
    ``record_function`` range of its name.
  * **Phase marks**: ``with phase("guides", device):`` names the round's
    phases (:data:`PHASES`) in the device's own stream, one empty kernel
    a phase entry (``kernels/csrc/phase_mark.cu``) while profiled or
    captured in a CUDA graph, so a trace splits even a replayed graph's
    round by phase; under the profiler it also opens the host range
    ``fl.<phase>``.
  * **On-device round telemetry**: :func:`make_round_telemetry_fn`
    builds the per-round block (C1/C2 pass counts, tag popcounts,
    update/guide norm summaries, async cohort and staleness counts), a
    pure function of the round's logs.  The engine writes it into
    preallocated (rounds,) device buffers and it leaves the card with the
    run's one host sync.
  * **The audit log**: :class:`AuditLog`, append-only and hash-chained.
    Each entry commits to the previous entry's digest, so any mutation,
    deletion or reordering of a committed entry breaks every digest after
    it.  Only ids, counts, versions and measurements are logged, never
    samples or updates.  ``launch/observe.py`` renders an exported run
    and verifies the chain.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import time
from typing import Any, Dict, List, Optional

import torch

from ..kernels.phase_mark import phase_mark_cuda

SCHEMA_VERSION = 1

# The hash chain's genesis digest: the first entry commits to this.
GENESIS = "0" * 64


# ----------------------------------------------------------------------
# Recorder: spans and events
# ----------------------------------------------------------------------

_NULL = contextlib.nullcontext()


def profiled(name: str):
    """``record_function(name)`` while ``torch.profiler`` records, else a
    no-op context: a host range the trace shows, at the cost of one check
    when nothing records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class Recorder:
    """Process-wide flight recorder.  An **event** is a point in time,
    ``{"type": "event", "kind", "t", **meta}``; a **span** an interval,
    ``{"type": "span", "name", "t0", "t1", "dur", "depth", **meta}``,
    ``depth`` its nesting level at entry.  Times are seconds since
    :meth:`start` on the monotonic clock; the wall-clock time of t = 0 is
    kept once in :attr:`wall0`.  While the profiler records, a span also
    opens a ``record_function`` range of its name."""

    def __init__(self):
        self.enabled = False
        self.records: List[dict] = []
        self.wall0 = 0.0
        self._t0 = 0.0
        self._depth = 0

    def start(self) -> "Recorder":
        self.records = []
        self.enabled = True
        self.wall0 = time.time()
        self._t0 = time.monotonic()
        self._depth = 0
        return self

    def stop(self) -> None:
        self.enabled = False

    def now(self) -> float:
        return time.monotonic() - self._t0

    def event(self, kind: str, **meta) -> None:
        if not self.enabled:
            return
        self.records.append({"type": "event", "kind": kind,
                             "t": round(self.now(), 6), **meta})

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if not self.enabled:
            yield
            return
        rec = {"type": "span", "name": name, "t0": round(self.now(), 6),
               "depth": self._depth, **meta}
        self._depth += 1
        try:
            with profiled(name):
                yield
        finally:
            self._depth -= 1
            rec["t1"] = round(self.now(), 6)
            rec["dur"] = round(rec["t1"] - rec["t0"], 6)
            self.records.append(rec)

    def snapshot(self) -> List[dict]:
        """A copy of the records so far."""
        return [dict(r) for r in self.records]

    def counts(self) -> Dict[str, int]:
        """``{"span:<name>" | "event:<kind>": count}``."""
        out: Dict[str, int] = {}
        for r in self.records:
            k = (f"span:{r['name']}" if r["type"] == "span"
                 else f"event:{r['kind']}")
            out[k] = out.get(k, 0) + 1
        return out


_RECORDER = Recorder()


def get_recorder() -> Recorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def event(kind: str, **meta) -> None:
    """One event on the process recorder (nothing when disabled)."""
    _RECORDER.event(kind, **meta)


def span(name: str, **meta):
    """One span on the process recorder (nothing when disabled)."""
    return _RECORDER.span(name, **meta)


# ----------------------------------------------------------------------
# Phase marks: the round's phases in the device's own stream
# ----------------------------------------------------------------------

# The cycle of a federated run, in order: a round's four phases (Step 2's
# local SGD with the selection, the minibatch gather and the data
# attacks; the update rows: update attacks, codec, residual write; the
# guides, and FLTrust's root update; the aggregation through the param
# apply), then at each eval point the eval and the hand-off to the host
# and the next segment.  A streaming round repeats the four per block.
PHASES = ("local_sgd", "update_rows", "guides", "aggregate", "eval",
          "handoff")
_PHASE_INDEX = {p: i for i, p in enumerate(PHASES)}


def phase(name: str, device=None):
    """``with phase(name, device):`` enters phase ``name`` of
    :data:`PHASES`.  While the profiler records, it opens the host range
    ``fl.<name>`` for the body.  On a CUDA ``device`` it launches the
    phase's mark, the kernel ``fl_phase_<name>``, on the current stream
    where a trace can see it: while the profiler records (inside that
    range), and while that stream captures a CUDA graph, which keeps the
    mark as a node of every replay.  An eager round that nothing profiles
    launches none.  A mark marks the entry only: on the device's timeline
    a phase lasts from its mark to the next, idle time included."""
    index = _PHASE_INDEX.get(name)
    if index is None:
        raise ValueError(f"unknown phase {name!r}; the phases are {PHASES}")
    if torch.autograd._profiler_enabled():
        return _traced_phase(name, index, device)
    if _on_card(device) and torch.cuda.is_current_stream_capturing():
        phase_mark_cuda(index, device)
    return _NULL


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def _traced_phase(name, index, device):
    with torch.profiler.record_function(f"fl.{name}"):
        if _on_card(device):
            phase_mark_cuda(index, device)
        yield

@contextlib.contextmanager
def recording(path: Optional[str] = None, audit: Optional["AuditLog"] = None,
              **meta):
    """Enable the process recorder for the ``with`` body; ``path`` exports
    the record as JSONL on exit (with ``audit``'s chain when given, and
    ``meta`` in the header)."""
    rec = _RECORDER.start()
    try:
        yield rec
    finally:
        rec.stop()
        if path is not None:
            export_jsonl(path, recorder=rec, audit=audit, meta=meta)


# ----------------------------------------------------------------------
# On-device round telemetry
# ----------------------------------------------------------------------

def make_round_telemetry_fn(cfg):
    """``tel_fn(logs) -> {name: 0-d device tensor}``: the per-round block
    the engine keeps when ``cfg.telemetry`` is on.  A pure function of the
    round's logs: ``kept``/``tagged`` count the keep-mask (over the rows
    that took part, ``cand``, in async rounds), ``c1_pass``/``c2_pass``
    the clients passing each DiverseFL criterion against ``cfg.dfl``,
    ``nonfinite`` the streaming guard's screened rows, the norm summaries
    reduce the logged ``z_sq``/``g_sq``, and the async counts pass
    through.  Which keys exist is fixed per config
    (``fl/metrics.round_telemetry_bytes`` counts them)."""
    dfl = cfg.dfl
    i32 = torch.int32

    def tel_fn(logs):
        t: Dict[str, Any] = {}
        if "mask" in logs:
            mask = logs["mask"].to(torch.bool)
            if "cand" in logs:
                cand = logs["cand"].to(torch.bool)
                t["kept"] = (mask & cand).sum(dtype=i32)
                t["tagged"] = (cand & ~mask).sum(dtype=i32)
            else:
                kept = mask.sum(dtype=i32)
                t["kept"] = kept
                t["tagged"] = mask.shape[0] - kept
        if "nonfinite" in logs:
            t["nonfinite"] = logs["nonfinite"].sum(dtype=i32)
        for k in ("cohort", "stale_buffered", "stale_folded",
                  "stale_expired"):
            if k in logs:
                t[k] = logs[k].to(i32)
        if "c1" in logs:
            t["c1_pass"] = (logs["c1"] > 0).sum(dtype=i32)
        if "c2" in logs:
            c2 = logs["c2"]
            t["c2_pass"] = ((c2 > dfl.eps2) & (c2 < dfl.eps3)).sum(dtype=i32)
        if "z_sq" in logs:
            zn = torch.sqrt(logs["z_sq"].to(torch.float32))
            t["upd_norm_mean"] = zn.mean()
            t["upd_norm_max"] = zn.max()
        if "g_sq" in logs:
            gn = torch.sqrt(logs["g_sq"].to(torch.float32))
            t["guide_norm_mean"] = gn.mean()
            t["guide_norm_max"] = gn.max()
        return t

    return tel_fn


def _canonical(obj) -> str:
    """Deterministic JSON: the byte string the chain digests commit to."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def entry_digest(index: int, kind: str, data: dict, prev: str) -> str:
    """sha256 over (previous digest ‖ canonical entry body)."""
    body = _canonical({"index": index, "kind": kind, "data": data})
    return hashlib.sha256((prev + body).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class AuditVerdict:
    ok: bool
    entries: int
    bad_index: int = -1          # first entry whose digest fails (-1: none)
    reason: str = ""

    def __bool__(self):
        return self.ok


class AuditLog:
    """Append-only hash-chained log of enclave-side decisions.

    Each entry is ``{"index", "kind", "data", "prev", "digest"}`` with
    ``digest = sha256(prev ‖ canonical_json({index, kind, data}))`` and
    entry 0 committing to :data:`GENESIS`."""

    def __init__(self):
        self.entries: List[dict] = []

    def append(self, kind: str, **data) -> dict:
        prev = self.entries[-1]["digest"] if self.entries else GENESIS
        index = len(self.entries)
        entry = {"index": index, "kind": kind, "data": data, "prev": prev,
                 "digest": entry_digest(index, kind, data, prev)}
        self.entries.append(entry)
        return entry

    @property
    def head(self) -> str:
        """The chain head digest (GENESIS when empty)."""
        return self.entries[-1]["digest"] if self.entries else GENESIS

    def verify(self) -> AuditVerdict:
        return verify_entries(self.entries)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out


def verify_entries(entries: List[dict]) -> AuditVerdict:
    """Recompute the hash chain of an entry list: sequential indices,
    ``prev`` chaining from GENESIS, and every stored digest.  Truthy iff
    the chain verifies; otherwise names the first bad entry."""
    prev = GENESIS
    for i, e in enumerate(entries):
        try:
            if e["index"] != i:
                return AuditVerdict(False, len(entries), i,
                                    f"index {e['index']} != position {i}")
            if e["prev"] != prev:
                return AuditVerdict(False, len(entries), i,
                                    "prev digest does not chain")
            want = entry_digest(i, e["kind"], e["data"], prev)
            if e["digest"] != want:
                return AuditVerdict(False, len(entries), i,
                                    "digest mismatch (entry mutated)")
            prev = e["digest"]
        except (KeyError, TypeError) as exc:
            return AuditVerdict(False, len(entries), i,
                                f"malformed entry: {exc}")
    return AuditVerdict(True, len(entries))


# ----------------------------------------------------------------------
# JSONL export and import (what launch/observe.py renders)
# ----------------------------------------------------------------------

def export_jsonl(path, recorder: Optional[Recorder] = None,
                 audit: Optional[AuditLog] = None,
                 meta: Optional[dict] = None) -> None:
    """One recorded run as JSONL: a header line (schema version,
    wall-clock epoch, run metadata), every span/event record, then the
    audit chain's entries (``"type": "audit"``)."""
    rec = recorder if recorder is not None else _RECORDER
    lines = [{"type": "header", "schema": SCHEMA_VERSION,
              "wall0": rec.wall0, "meta": meta or {}}]
    lines += rec.snapshot()
    if audit is not None:
        lines += [{"type": "audit", **e} for e in audit.entries]
    with open(path, "w") as f:
        for line in lines:
            f.write(_canonical(line) + "\n")


def load_jsonl(path) -> Dict[str, Any]:
    """An exported run: ``{"header", "spans", "events", "audit"}``, the
    audit entries in the shape :func:`verify_entries` checks."""
    header, spans, events, audit = {}, [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "header":
                header = rec
            elif kind == "span":
                spans.append(rec)
            elif kind == "event":
                events.append(rec)
            elif kind == "audit":
                audit.append({k: rec[k] for k in
                              ("index", "kind", "data", "prev", "digest")})
    return {"header": header, "spans": spans, "events": events,
            "audit": audit}
