"""The enclave's audit log: append-only and hash-chained.

The port's copy of the reference's ``AuditLog``, ``GENESIS`` and
``verify_entries``.  Each entry commits to the previous entry's digest,
so any mutation, deletion or reordering of a committed entry breaks
every digest after it.  Only ids, counts, versions and measurements are
logged — never samples or updates.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List

# The hash chain's genesis digest: the first entry commits to this.
GENESIS = "0" * 64


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
