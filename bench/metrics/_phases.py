"""Shared arithmetic of the phase readers (``<phase>_ms``): the traced
window split by the program's phase marks.

The program launches one empty kernel, ``fl_phase_<phase>``, in the
round's own stream as it enters each phase of its round (local SGD,
update rows, guides, aggregation) and of each eval point (eval, hand-off);
a captured CUDA graph keeps them as nodes, so they split a replayed round
too.  A mark marks an entry only: every device operation and idle gap
from one mark to the next belongs to the first mark's phase.  The window
holds whole segments, each closed by its hand-off, so the stretch before
the window's first mark is the hand-off's too, and the phases tile the
window exactly.

The marks are held to the order the program enters them in
(:func:`in_order`), and, where the cell's ``eval_every`` is known, to one
hand-off a segment.  Where the profile lost the window's tail, as a long
profile can, the marks stop before the last hand-off: the split then
keeps the whole segments before the loss and counts their rounds by
``eval_every``, so a lost tail costs rounds and not the numbers.  A trace
without marks (a program without them, or a run off the card), with
marks out of order, with fewer hand-offs than segments yet ending on
one, or without one whole segment, splits nothing: :func:`split` returns
None."""
import bisect
import itertools
from typing import Dict, List, Optional, Tuple

from bench.harness.trace import Trace, busy_intervals, phase_of

ROUND = ("local_sgd", "update_rows", "guides", "aggregate")


def marks(trace: Trace) -> List[Tuple[float, str]]:
    """(start, phase) of each mark that starts inside the window, in
    device order."""
    return sorted((k.ts, phase_of(k)) for k in trace.marks
                  if trace.t0 <= k.ts < trace.t1)


def _follows(a: str, b: str) -> bool:
    """Whether mark ``b`` may follow mark ``a``: a round's phases in
    ``ROUND`` order (guides may repeat: FLTrust's root, stragglers'
    guides), ``local_sgd`` opening each round and fold block, and an eval
    point's eval after an aggregation, its hand-off right after it."""
    if a == "eval" or b == "handoff":
        return a == "eval" and b == "handoff"
    if b == "eval":
        return a == "aggregate"
    if b == "local_sgd":
        return a in ROUND or a == "handoff"
    return (a in ROUND and b in ROUND
            and ROUND.index(b) >= ROUND.index(a))


def in_order(ms: List[Tuple[float, str]]) -> bool:
    """Whether the marks open a segment and follow each other as the
    program enters them."""
    return bool(ms) and ms[0][1] == "local_sgd" and all(
        _follows(a, b) for (_, a), (_, b) in zip(ms, ms[1:]))


def intervals(trace: Trace, ctx: Optional[dict] = None
              ) -> Optional[Tuple[List[Tuple[float, float, str]], int]]:
    """The window's whole segments cut at each mark: ((start, end,
    phase), ...) tiling them, and their rounds; None where nothing
    splits."""
    ms = marks(trace)
    if not in_order(ms):
        return None
    ends = [i for i, (_, p) in enumerate(ms) if p == "handoff"]
    every = int(((ctx or {}).get("traffic") or {}).get("eval_every") or 0)
    whole = ms[-1][1] == "handoff"
    if whole and (not every or len(ends) * every == trace.rounds):
        t1, rounds = trace.t1, trace.rounds
    elif not whole and ends and every and len(ends) * every < trace.rounds:
        # the profile lost the tail: keep the whole segments before it
        t1, rounds = ms[ends[-1] + 1][0], len(ends) * every
        ms = ms[:ends[-1] + 1]
    else:
        return None
    out = [(trace.t0, ms[0][0], "handoff")] if ms[0][0] > trace.t0 else []
    for (a, p), (b, _) in zip(ms, ms[1:] + [(t1, None)]):
        out.append((a, b, p))
    return out, rounds


def _overlap(starts: List[float], ends: List[float], cum: List[float],
             a: float, b: float) -> float:
    """The part of [a, b) that sorted, disjoint intervals cover, from
    their ``starts``, ``ends`` and the prefix sums ``cum`` of their
    lengths: two bisections, not a pass over all of them."""
    i = bisect.bisect_right(ends, a)
    j = bisect.bisect_left(starts, b)
    if i >= j:
        return 0.0
    return (cum[j] - cum[i] - max(0.0, a - starts[i])
            - max(0.0, ends[j - 1] - b))


def split(trace: Trace, ctx: Optional[dict] = None
          ) -> Optional[Tuple[Dict[str, dict], int]]:
    """Per phase: ``us`` (its share of the split window), ``busy_us`` (the
    part in which a device operation other than a mark runs) and
    ``kernels`` (the kernels that start in it, marks left out); and the
    split window's rounds.
    None where nothing splits."""
    cut = intervals(trace, ctx)
    if cut is None:
        return None
    busy = busy_intervals(trace)
    starts, ends = [a for a, _ in busy], [b for _, b in busy]
    cum = list(itertools.accumulate((b - a for a, b in busy), initial=0.0))
    work = sorted(k.ts for k in trace.kernels)
    out: Dict[str, dict] = {}
    for a, b, p in cut[0]:
        d = out.setdefault(p, {"us": 0.0, "busy_us": 0.0, "kernels": 0})
        d["us"] += b - a
        d["busy_us"] += _overlap(starts, ends, cum, a, b)
        d["kernels"] += bisect.bisect_left(work, b) - \
            bisect.bisect_left(work, a)
    return out, cut[1]


def phase_ms(trace: Trace, ctx: Optional[dict], phase: str
             ) -> Optional[float]:
    """Device ms a round of ``phase``: its intervals summed over the split
    window, over that window's rounds (0 where the marks never enter it);
    None where nothing splits."""
    got = split(trace, ctx)
    if got is None or not got[1]:
        return None
    parts, rounds = got
    return parts.get(phase, {"us": 0.0})["us"] / 1e3 / rounds
