"""The port's flight recorder (``repro_torch.fl.telemetry``), its audit
chain and ``repro_torch.launch.observe``, on the CPU.

* The recorder: silent when off, nested spans, events, a fresh record per
  ``recording``; the build counter's scoped deltas.
* The audit chain verifies and catches a mutated, reordered, deleted or
  forged entry; the SecureServer logs its lifecycle and, after a
  telemetry run's one host sync, every round's tags.
* Telemetry on equals telemetry off, bit for bit; the per-round block
  equals the reference's block on the same logs; ``round_telemetry_bytes``
  equals the reference's for the same configs and the block's size.
* ``export_jsonl``/``load_jsonl`` round-trip; ``observe`` renders and
  verifies; ``observe --selftest`` passes with ``device="cpu"``.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_s5 import (LR, cfg, federation, jax_cfg, model, port_data,
                       same_history)
from repro.fl.metrics import round_telemetry_bytes as jax_tel_bytes
from repro.fl.telemetry import make_round_telemetry_fn as jax_tel_fn
from repro_torch.core.attacks import AttackConfig
from repro_torch.fl import RoundEngine, run_federated_training, telemetry
from repro_torch.fl.faults import FaultConfig
from repro_torch.fl.metrics import round_telemetry_bytes
from repro_torch.launch import observe


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in parallel workers that share the machine's cores;
    several torch thread pools on them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return port_data()


def test_a_disabled_recorder_is_silent():
    rec = telemetry.Recorder()
    rec.event("x", a=1)
    with rec.span("s"):
        pass
    assert rec.records == [] and rec.counts() == {}
    assert not telemetry.enabled() or telemetry.get_recorder().enabled


def test_spans_nest_and_events_interleave():
    with telemetry.recording() as rec:
        with telemetry.span("outer", n=3):
            telemetry.event("tick", k=1)
            with telemetry.span("inner"):
                pass
    assert not telemetry.enabled()
    spans = {r["name"]: r for r in rec.records if r["type"] == "span"}
    assert spans["outer"]["depth"] == 0 and spans["inner"]["depth"] == 1
    assert spans["outer"]["n"] == 3
    assert spans["outer"]["t0"] <= spans["inner"]["t0"] <= \
        spans["inner"]["t1"] <= spans["outer"]["t1"]
    assert rec.counts() == {"span:outer": 1, "span:inner": 1,
                            "event:tick": 1}
    snap = rec.snapshot()
    snap[0]["name"] = "changed"
    assert rec.records[0].get("name") != "changed"


def test_recording_resets_between_uses():
    with telemetry.recording() as rec:
        telemetry.event("a")
    with telemetry.recording() as rec2:
        telemetry.event("b")
    assert rec is rec2 and [r["kind"] for r in rec2.records] == ["b"]


def test_audit_chain_verifies_and_heads():
    log = telemetry.AuditLog()
    assert log.head == telemetry.GENESIS and log.verify()
    for i in range(4):
        log.append("round_tags", round=i, kept=3)
    assert log.verify() and log.verify().entries == 4
    assert log.head == log.entries[-1]["digest"]
    assert log.counts() == {"round_tags": 4}


@pytest.mark.parametrize("tamper,bad", [
    (lambda e: e[2]["data"].update(kept=9), 2),
    (lambda e: e.insert(1, e.pop(2)), 1),
    (lambda e: e.pop(1), 1),
    (lambda e: e.append(dict(e[-1], index=len(e))), 4),
    (lambda e: e[3].pop("digest"), 3),
], ids=["mutated", "reordered", "deleted", "forged-tail", "malformed"])
def test_audit_tampering_is_caught(tamper, bad):
    log = telemetry.AuditLog()
    for i in range(4):
        log.append("round_tags", round=i, kept=i)
    entries = copy.deepcopy(log.entries)
    tamper(entries)
    verdict = telemetry.verify_entries(entries)
    assert not verdict and verdict.bad_index == bad and verdict.reason


def test_the_server_audits_its_lifecycle_and_rounds(data):
    c = cfg(telemetry=True)
    fed = federation(c, data)
    kinds = fed.server.audit.counts()
    assert kinds["attestation"] == 1 and kinds["seal"] == c.n_clients
    run_federated_training(model(), fed, c, LR)
    tags = [e for e in fed.server.audit.entries if e["kind"] == "round_tags"]
    assert [e["data"]["round"] for e in tags] == list(range(1, c.rounds + 1))
    assert set(tags[0]["data"]) == {"round", "kept", "tagged", "c1_pass",
                                    "c2_pass"}
    assert fed.server.audit.verify()
    with pytest.raises(ValueError, match="unknown staleness decision"):
        fed.server.record_stale(1, "lost", 1)


def test_telemetry_off_appends_no_round_tags(data):
    c = cfg()
    fed = federation(c, data)
    run_federated_training(model(), fed, c, LR)
    assert "round_tags" not in fed.server.audit.counts()


@pytest.mark.parametrize("kw", [
    dict(), dict(aggregator="oracle", streaming=True, client_chunk=4),
    dict(aggregator="diversefl", streaming=True, client_chunk=4,
         cohort_participation=0.8, staleness_buffer=2,
         fault=FaultConfig("intermittent", rate=0.3)),
    dict(aggregator="fltrust", eval_every=1)], ids=["dense", "oracle",
                                                    "async", "fltrust"])
def test_histories_are_bitwise_with_telemetry_on(data, kw):
    off = cfg(**kw)
    on = cfg(telemetry=True, **kw)
    h_off = run_federated_training(model(), federation(off, data), off, LR)
    h_on = run_federated_training(model(), federation(on, data), on, LR)
    assert same_history(h_on, h_off)


def _logs(n=6, b=2, async_=True):
    rng = np.random.default_rng(0)
    logs = {"mask": rng.random(n + b) < 0.6,
            "c1": np.sign(rng.normal(size=n + b)).astype(np.float32),
            "c2": (rng.random(n + b) * 3).astype(np.float32),
            "z_sq": rng.random(n + b).astype(np.float32),
            "g_sq": rng.random(n + b).astype(np.float32),
            "nonfinite": rng.random(n + b) < 0.2}
    if async_:
        logs.update(cand=rng.random(n + b) < 0.8,
                    cohort=np.int32(5), stale_buffered=np.int32(2),
                    stale_folded=np.int32(1), stale_expired=np.int32(0))
    return logs


@pytest.mark.parametrize("async_", [True, False])
def test_the_round_block_matches_the_reference(async_):
    c = cfg(aggregator="diversefl", streaming=True)
    logs = _logs(async_=async_)
    want = jax_tel_fn(jax_cfg(c))({k: jnp.asarray(v)
                                   for k, v in logs.items()})
    got = telemetry.make_round_telemetry_fn(c)(
        {k: torch.as_tensor(np.array(v)) for k, v in logs.items()})
    assert set(got) == set(want)
    for k in got:
        assert got[k].dim() == 0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(aggregator="diversefl"), dict(aggregator="oracle"),
    dict(aggregator="mean"), dict(aggregator="fltrust"),
    dict(aggregator="median"),
    dict(aggregator="diversefl", streaming=True),
    dict(aggregator="oracle", streaming=True, compression="int8"),
    dict(aggregator="diversefl", streaming=True, staleness_buffer=2,
         fault=FaultConfig("straggler", rate=0.2))])
def test_round_telemetry_bytes_match_the_reference(data, kw):
    c = cfg(telemetry=True, **kw)
    assert round_telemetry_bytes(c) == jax_tel_bytes(jax_cfg(c))
    if kw["aggregator"] == "median":
        return
    # the block's size from a real run
    eng = RoundEngine(model(), federation(c, data), c)
    p0 = model().init(torch.Generator().manual_seed(1), "cpu")
    lrs = torch.tensor([LR(i) for i in range(1, c.rounds + 1)])
    _, _, m, _ = eng.run_training(p0, torch.Generator().manual_seed(0), lrs)
    per_round = sum(v[0].numel() * v.element_size()
                    for v in m.get("_tel", {}).values())
    assert per_round == round_telemetry_bytes(c)


def test_export_load_roundtrip(tmp_path, data):
    c = cfg(telemetry=True)
    fed = federation(c, data)
    path = tmp_path / "run.jsonl"
    with telemetry.recording(str(path), audit=fed.server.audit,
                             run="rt") as rec:
        run_federated_training(model(), fed, c, LR)
    run = telemetry.load_jsonl(str(path))
    assert run["header"]["schema"] == telemetry.SCHEMA_VERSION
    assert run["header"]["meta"] == {"run": "rt"}
    assert run["audit"] == fed.server.audit.entries
    assert telemetry.verify_entries(run["audit"])
    assert len(run["spans"]) == len([r for r in rec.records
                                     if r["type"] == "span"])
    assert [e["kind"] for e in run["events"]].count("round") == c.rounds
    assert [e["kind"] for e in run["events"]].count("sync") == 1


def test_observe_renders_and_verifies(tmp_path, data, capsys):
    c = cfg(telemetry=True, attack=AttackConfig(kind="sign_flip"))
    fed = federation(c, data)
    path = str(tmp_path / "run.jsonl")
    with telemetry.recording(path, audit=fed.server.audit, run="obs"):
        run_federated_training(model(), fed, c, LR)
    assert observe.main([path]) == 0
    out = capsys.readouterr().out
    assert "span waterfall" in out and "round timeline" in out
    assert "VERIFIED" in out and "1 syncs" in out
    assert observe.main([path, "--summary"]) == 0
    lines = open(path).read().splitlines()
    i = next(j for j, line in enumerate(lines) if '"type":"audit"' in line)
    lines[i + 1] = lines[i + 1].replace('"kind":"seal"', '"kind":"drop"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    assert observe.main([path]) == 1
    assert "BROKEN" in capsys.readouterr().out


def test_observe_selftest_on_the_cpu(tmp_path):
    assert observe.selftest(str(tmp_path / "self.jsonl"), device="cpu")
