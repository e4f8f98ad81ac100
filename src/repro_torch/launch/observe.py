"""Render a recorded run: span waterfall, round timeline, audit chain.

The flight recorder (``fl/telemetry.py``) exports one training run as
JSONL: a header, the span/event stream and the SecureServer's
hash-chained audit log.  This CLI is the read side:

  * **verify** the audit chain end to end (every entry's digest
    recomputed against its predecessor; a mutation names the first bad
    entry and exits non-zero);
  * **waterfall** the spans (indented by nesting depth, with durations,
    and the build/capture/sync events placed among them);
  * **timeline** the per-round telemetry (kept/tagged counts, C1/C2 pass
    counts, norm summaries, async cohort and staleness counts, uplink
    bytes), one row per round.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.observe run.jsonl
  PYTHONPATH=src python -m repro_torch.launch.observe run.jsonl --summary
  PYTHONPATH=src python -m repro_torch.launch.observe --selftest [--device cpu]
      record a small training in-process (on the card unless --device
      says otherwise), export, verify, render
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..fl import telemetry


# ----------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------

def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}GB"


def render_waterfall(spans, events, out=None):
    """Spans indented by depth, in start order; trace/sync events with a
    timestamp inside the window they fired in."""
    out = sys.stdout if out is None else out
    rows = []
    for s in spans:
        meta = {k: v for k, v in s.items()
                if k not in ("type", "name", "t0", "t1", "dur", "depth")
                and v is not None}
        rows.append((s["t0"], s.get("depth", 0), s["name"],
                     f"{s.get('dur', 0):8.3f}s",
                     " ".join(f"{k}={v}" for k, v in sorted(meta.items()))))
    for e in events:
        if e["kind"] in ("trace", "sync", "streaming_fallback",
                         "sweep_group_builds", "capture"):
            meta = {k: v for k, v in e.items()
                    if k not in ("type", "kind", "t") and v is not None}
            if e["kind"] == "sync":
                meta["bytes"] = _fmt_bytes(meta.get("bytes"))
            rows.append((e["t"], 99, f"* {e['kind']}", f"@{e['t']:7.3f}s",
                        " ".join(f"{k}={v}" for k, v in sorted(meta.items()))))
    rows.sort(key=lambda r: r[0])
    print("-- span waterfall " + "-" * 44, file=out)
    for t, depth, name, dur, meta in rows:
        indent = "  " * min(depth, 6) if depth != 99 else "    "
        print(f"  {indent}{name:<28} {dur}  {meta}", file=out)


ROUND_COLS = ("kept", "tagged", "c1_pass", "c2_pass", "nonfinite", "cohort",
              "stale_buffered", "stale_folded", "stale_expired",
              "upd_norm_mean", "guide_norm_mean", "uplink_bytes")


def render_round_timeline(events, out=None):
    """One row per recorded round: tag decisions, criterion pass counts,
    norm summaries, comm bytes."""
    out = sys.stdout if out is None else out
    rounds = [e for e in events if e["kind"] == "round"]
    if not rounds:
        print("-- no per-round telemetry recorded (FLConfig.telemetry "
              "was off) --", file=out)
        return
    cols = [c for c in ROUND_COLS if any(c in e for e in rounds)]
    has_cell = any("cell" in e for e in rounds)
    print("-- round timeline " + "-" * 44, file=out)
    hdr = "  round" + ("  cell" if has_cell else "")
    print(hdr + "".join(f"  {c:>15}" for c in cols), file=out)
    for e in rounds:
        row = f"  {e.get('index', '?'):>5}"
        if has_cell:
            row += f"  {e.get('cell', '-'):>4}"
        for c in cols:
            v = e.get(c)
            if v is None:
                cell = "-"
            elif c == "uplink_bytes":
                cell = _fmt_bytes(v)
            elif isinstance(v, float):
                cell = f"{v:.4f}"
            else:
                cell = str(v)
            row += f"  {cell:>15}"
        print(row, file=out)


def render_audit(audit, out=None):
    out = sys.stdout if out is None else out
    verdict = telemetry.verify_entries(audit)
    print("-- enclave audit chain " + "-" * 39, file=out)
    kinds = {}
    for e in audit:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"  entries: {verdict.entries}  "
          + " ".join(f"{k}={v}" for k, v in sorted(kinds.items())), file=out)
    if verdict:
        head = audit[-1]["digest"][:16] if audit else telemetry.GENESIS[:16]
        print(f"  chain: VERIFIED (head {head}…)", file=out)
    else:
        print(f"  chain: BROKEN at entry {verdict.bad_index}: "
              f"{verdict.reason}", file=out)
    return bool(verdict)


def summarize(run) -> str:
    spans, events, audit = run["spans"], run["events"], run["audit"]
    syncs = [e for e in events if e["kind"] == "sync"]
    rounds = [e for e in events if e["kind"] == "round"]
    traces = [e for e in events if e["kind"] == "capture"]
    verdict = telemetry.verify_entries(audit)
    total = max((s.get("t1", 0) for s in spans), default=0.0)
    return (f"{len(spans)} spans over {total:.3f}s, {len(traces)} captures, "
            f"{len(syncs)} syncs ({_fmt_bytes(sum(e.get('bytes', 0) for e in syncs))}), "
            f"{len(rounds)} round records, audit "
            f"{'VERIFIED' if verdict else 'BROKEN'} "
            f"({verdict.entries} entries)")


def render(path, summary_only=False, out=None) -> bool:
    """Load + verify + render one exported run; True iff the audit chain
    verifies (the CLI's exit status)."""
    out = sys.stdout if out is None else out
    run = telemetry.load_jsonl(path)
    meta = run["header"].get("meta", {})
    if meta:
        print("meta: " + " ".join(f"{k}={v}"
                                  for k, v in sorted(meta.items())), file=out)
    if summary_only:
        print(summarize(run), file=out)
        return bool(telemetry.verify_entries(run["audit"]))
    render_waterfall(run["spans"], run["events"], out=out)
    render_round_timeline(run["events"], out=out)
    ok = render_audit(run["audit"], out=out)
    print(summarize(run), file=out)
    return ok


# ----------------------------------------------------------------------
# selftest
# ----------------------------------------------------------------------

def selftest(path=None, device=None) -> bool:
    """Record a small telemetry-enabled training end to end, export it,
    verify the audit chain (and that tampering is caught) and render it;
    then an async run (cohorts, stragglers, a staleness buffer) whose
    chain must hold the cohort and staleness entries.  Runs on the card
    unless ``device`` says otherwise.  True on success."""
    import copy

    import numpy as np
    import torch

    from ..core.attacks import AttackConfig
    from ..data import FederatedData, partition_sorted_shards
    from ..device import resolve_device
    from ..fl import (FLConfig, Federation, run_federated_training,
                      softmax_regression)
    from ..fl.faults import FaultConfig
    from ..optim import inv_sqrt_lr

    dev = resolve_device(device)
    if path is None:
        path = os.path.join(tempfile.mkdtemp(prefix="observe_"),
                            "selftest.jsonl")
    N, DIM, K = 16, 8, 3

    def make(n, seed):
        g = torch.Generator().manual_seed(seed)
        centers = torch.randn((K, DIM), generator=g) * 3.0
        y = torch.randint(0, K, (n,), generator=g)
        x = centers[y] + torch.randn((n, DIM), generator=g)
        return x.to(dev), y.to(dev)

    x, y = make(N * 8, 0)
    data = FederatedData.from_partitions(partition_sorted_shards(x, y, N), K)
    tx, ty = make(64, 9)
    model = softmax_regression(input_dim=DIM, n_classes=K)

    def fed_for(cfg):
        return Federation.create(model, data, tx, ty, cfg,
                                 torch.Generator(device=dev).manual_seed(2),
                                 device=dev)

    def train(tel):
        cfg = FLConfig(n_clients=N, f=3, rounds=7, eval_every=3,
                       batch_size=2, attack=AttackConfig(kind="sign_flip"),
                       telemetry=tel)
        fed = fed_for(cfg)
        return run_federated_training(model, fed, cfg,
                                      inv_sqrt_lr(0.05)), fed

    h_off, _ = train(False)
    with telemetry.recording() as rec:
        h_on, fed = train(True)
        telemetry.export_jsonl(path, recorder=rec, audit=fed.server.audit,
                               meta={"run": "observe-selftest",
                                     "device": str(dev)})

    # telemetry must not perturb the training: histories bitwise equal
    for k in ("round", "acc", "mask_tpr", "mask_fpr"):
        assert np.array_equal(np.asarray(h_off[k]), np.asarray(h_on[k])), \
            f"telemetry changed history[{k!r}]"
    for k in h_off["params"]:
        assert torch.equal(h_off["params"][k], h_on["params"][k]), \
            f"telemetry changed params[{k!r}]"

    run = telemetry.load_jsonl(path)
    assert len([e for e in run["events"] if e["kind"] == "sync"]) == 1, \
        "the one-sync run must record exactly one sync event"
    assert len([e for e in run["events"] if e["kind"] == "round"]) == 7, \
        "expected one round record per round"
    assert telemetry.verify_entries(run["audit"]), "audit chain broken"

    # the chain must bind: a mutated entry fails verification
    tampered = copy.deepcopy(run["audit"])
    tampered[len(tampered) // 2]["data"]["forged"] = 1
    bad = telemetry.verify_entries(tampered)
    assert not bad and bad.bad_index == len(tampered) // 2, \
        "tampered audit entry went undetected"

    ok = render(path)

    # async leg: a faulty, cohort-resampled, buffered run lands
    # cohort_resample and stale_* entries on the chain and the async
    # columns in the round records, and still verifies
    async_path = path.replace(".jsonl", "_async.jsonl")
    cfg = FLConfig(n_clients=N, f=3, rounds=7, eval_every=3, batch_size=2,
                   attack=AttackConfig(kind="sign_flip"), streaming=True,
                   telemetry=True, cohort_participation=0.75,
                   staleness_buffer=4,
                   fault=FaultConfig(kind="straggler", rate=0.3, delay=1))
    fed = fed_for(cfg)
    with telemetry.recording() as rec:
        run_federated_training(model, fed, cfg, inv_sqrt_lr(0.05))
        telemetry.export_jsonl(async_path, recorder=rec,
                               audit=fed.server.audit,
                               meta={"run": "observe-selftest-async",
                                     "device": str(dev)})
    arun = telemetry.load_jsonl(async_path)
    kinds = {e["kind"] for e in arun["audit"]}
    assert "cohort_resample" in kinds, \
        "async run recorded no cohort_resample audit entries"
    assert kinds & {"stale_buffered", "stale_folded", "stale_expired"}, \
        "async straggler run recorded no stale_* audit entries"
    rounds = [e for e in arun["events"] if e["kind"] == "round"]
    assert rounds and all("cohort" in e and "stale_buffered" in e
                          for e in rounds), \
        "async round telemetry missing cohort/stale columns"
    assert telemetry.verify_entries(arun["audit"]), \
        "async audit chain broken"
    ok = render(async_path) and ok

    print(f"observe selftest: OK ({dev})")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", help="exported run (JSONL)")
    ap.add_argument("--summary", action="store_true",
                    help="one-line summary instead of the full render")
    ap.add_argument("--selftest", action="store_true",
                    help="record + export + verify + render a tiny run")
    ap.add_argument("--device", default=None,
                    help="the selftest's device (default: the card)")
    args = ap.parse_args(argv)
    if args.selftest:
        return 0 if selftest(device=args.device) else 1
    if not args.path:
        ap.error("need a JSONL path (or --selftest)")
    return 0 if render(args.path, summary_only=args.summary) else 1


if __name__ == "__main__":
    raise SystemExit(main())
