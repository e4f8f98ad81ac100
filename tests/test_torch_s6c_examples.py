"""The reference's five examples as ``repro_torch.examples`` entry points,
on the CPU.

* ``quickstart`` at full size (60 rounds): diversefl under sign_flip
  within 0.03 of oracle with TPR 1, and above mean + 0.3 under gaussian
  with TPR 1 / FPR 0 (``PERF.md`` §2).  At the reference's seeds the CPU's
  draws flag one of 18 benign clients under sign_flip (FPR 1/18): held
  as a strict miss (``CPU_MISSES``), so a draw that meets the bar fails
  the test until the record goes.
* ``attack_gallery`` at 10 rounds: under sign_flip and same_value every
  Byzantine client's C1 x C2 lies below every benign client's.
* ``paper_grid`` at 2 rounds: 48 rows, in the reference's
  ``SweepSpec.cells()`` order.
* ``serve_decode``: with the reference's ``models.init(PRNGKey(0), cfg)``
  params carried over and its prompt, the tokens equal the reference
  example's decode loop in JAX up to each sequence's first step whose
  top-2 logit gap is under 1e-3.
* ``train_fl_llm`` at 2 layers x 64 wide on a 2 x 2 gloo mesh, 2 rounds:
  the sign-flip client is dropped (TPR 1) at every eval, and ``--ckpt``
  restores bitwise the final params; a mesh wider than the cards is
  refused by name on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.core.attacks import AttackConfig as JAttackConfig
from repro.fl import FLConfig as JFLConfig
from repro.fl import SweepSpec as JSweepSpec
from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.convert import tree_from_jax
from repro_torch.examples import (attack_gallery, paper_grid, quickstart,
                                  serve_decode, train_fl_llm)

# (aggregator, attack) -> the bar the CPU's draws miss at the reference's
# seeds, and by how much.  A miss of the draws, not of the port:
# tests/example_seed_scan.py (seeds 0-15 on the CPU, both packages) meets
# TPR 1 / FPR 0 at 9 of 16 seeds in the reference and at 11 of 16 in the
# port, each missing by one benign client flagged (FPR 1/18)
CPU_MISSES = {("diversefl", "sign_flip"): ("fpr", np.float32(1) / 18)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_meets_the_bars(capsys):
    rows = {(r["aggregator"], r["attack"]): r
            for r in quickstart.main(["--device", "cpu"])}
    assert list(rows) == list(quickstart.RUNS)
    dfl, orc = rows["diversefl", "sign_flip"], rows["oracle", "sign_flip"]
    dfg, mean = rows["diversefl", "gaussian"], rows["mean", "gaussian"]
    assert dfl["acc"] >= orc["acc"] - 0.03
    assert dfg["acc"] > mean["acc"] + 0.3
    assert dfl["tpr"] == 1.0 and dfg["tpr"] == 1.0 and dfg["fpr"] == 0.0
    (key, value), = CPU_MISSES.items()
    assert rows[key][value[0]] == pytest.approx(float(value[1]), abs=1e-7)
    out = capsys.readouterr().out
    assert "registered aggregation rules: diversefl" in out
    assert "mean         gaussian" in out


def test_attack_gallery_separates_byzantine_clients(capsys):
    rows = attack_gallery.main(["--device", "cpu", "--rounds", "10"])
    assert [r["attack"] for r in rows] == list(attack_gallery.ATTACKS)
    for r in rows:
        byz, c = np.asarray(r["byz"]), np.asarray(r["c1c2"])
        assert byz.sum() == 5 and c.shape == (23,)
        if r["attack"] in ("sign_flip", "same_value"):
            assert c[byz].max() < c[~byz].min(), r["attack"]
    assert "=== attack: sign_flip" in capsys.readouterr().out


def test_paper_grid_rows_follow_the_reference_cells(capsys):
    rows = paper_grid.main(["--device", "cpu", "--rounds", "2"])
    jattacks = (JAttackConfig(kind="gaussian", sigma=1e4),
                JAttackConfig(kind="sign_flip"),
                JAttackConfig(kind="label_flip"),
                JAttackConfig(kind="backdoor", source_class=3,
                              target_class=4))
    jspec = JSweepSpec(base=JFLConfig(rounds=2, batch_size=50, eval_every=2),
                       seeds=paper_grid.SEEDS,
                       aggregators=paper_grid.AGGREGATORS, attacks=jattacks)
    want = [(c.cfg.aggregator, c.cfg.attack.kind, c.cfg.seed)
            for c in jspec.cells()]
    assert len(rows) == 48
    assert [(r["aggregator"], r["attack"], r["seed"]) for r in rows] == want
    assert all(0.0 <= r["final_acc"] <= 1.0 for r in rows)
    out = capsys.readouterr().out
    assert "48 runs in" in out and "16 engine builds" in out


def _reference_decode(jcfg, jparams, prompt, gen):
    """The reference example's loop (``examples/serve_decode.py``), with
    each step's top-2 logit gap."""
    B, P = prompt.shape
    decode = jax.jit(lambda p, t, c, i: jmodels.decode_step(p, jcfg, t, c, i))
    cache = jmodels.init_cache(jcfg, B, P + gen)
    tok = prompt[:, :1]
    out, gaps = [tok], [np.full((B, 1), np.inf, np.float32)]
    for t in range(P + gen - 1):
        lg, cache = decode(jparams, tok, cache, jnp.int32(t))
        if t + 1 < P:
            tok = prompt[:, t + 1:t + 2]
            gaps.append(np.full((B, 1), np.inf, np.float32))
        else:
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            top2 = np.sort(np.asarray(lg[:, 0], np.float32), axis=-1)
            gaps.append(top2[:, -1:] - top2[:, -2:-1])
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1)), np.concatenate(gaps, 1)


def test_serve_decode_matches_the_reference_loop():
    arch, P, gen, B = "h2o-danube-1.8b", 16, 24, 4
    jcfg, cfg = jconfigs.get(arch, smoke=True), configs.get(arch, smoke=True)
    jparams = jmodels.init(jax.random.PRNGKey(0), jcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                jcfg.vocab_size)
    want, jgaps = _reference_decode(jcfg, jparams, prompt, gen)
    params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    got, gaps = serve_decode.generate(
        cfg, params, torch.from_numpy(np.array(prompt)), gen, "cpu")
    assert got.shape == (B, P + gen) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :P], np.asarray(prompt))
    held = serve_decode.agree_until_tie(got, want, np.minimum(gaps, jgaps))
    assert min(held) > P, held     # greedy tokens are compared


def test_serve_decode_main_and_agreement_rule(capsys):
    rows = serve_decode.main(["--device", "cpu", "--gen", "6"])
    assert len(rows) == 4 and all(len(r["tokens"]) == 6 for r in rows)
    assert "h2o-danube-1.8b (reduced): generated 6 tokens x 4" in \
        capsys.readouterr().out
    a = np.array([[1, 2, 3, 4]])
    gaps = np.array([[np.inf, 1.0, 1e-4, 1.0]])
    assert serve_decode.agree_until_tie(a, np.array([[1, 2, 9, 9]]),
                                        gaps) == [2]
    with pytest.raises(AssertionError, match="token 1 differs"):
        serve_decode.agree_until_tie(a, np.array([[1, 5, 3, 4]]), gaps)


def test_train_fl_llm_drops_the_flipper_and_restores(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = train_fl_llm.parse_args(
        ["--device", "cpu", "--layers", "2", "--d-model", "64", "--seq",
         "32", "--rounds", "2", "--eval-every", "1", "--data", "2",
         "--model", "2", "--ckpt", ckpt])
    res = train_fl_llm.run(args, timeout=240)
    assert res["eval_rounds"] == [1, 2]
    assert res["model_shards"] == 2
    assert res["mesh"] == {"data": 2, "model": 2}
    assert list(res["metrics"]["mask_tpr"]) == [1.0, 1.0]
    for k, v in res["metrics"].items():
        assert np.isfinite(np.asarray(v, np.float64)).all(), k
    rows = train_fl_llm.report(args, res)
    assert [r["tpr"] for r in rows] == [1.0, 1.0]
    assert "byz-detect-tpr=1.00" in capsys.readouterr().out
    restored, step = restore_checkpoint(ckpt, device="cpu")
    assert step == 2 and set(restored) == set(res["params"])
    for k, v in res["params"].items():
        assert torch.equal(restored[k], v), k


def test_train_fl_llm_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(train_fl_llm, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL takes one rank a card"):
        train_fl_llm.run(train_fl_llm.parse_args([]))


def test_smoke_config_is_the_reference_example_config():
    """serve_decode's config is the reference example's (SMOKE) one."""
    j = jconfigs.get("h2o-danube-1.8b", smoke=True)
    t = configs.get("h2o-danube-1.8b", smoke=True)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
