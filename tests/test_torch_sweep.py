"""Experiment sweeps of the port (``repro_torch.fl.sweep``) on the CPU.

* Every cell of a sweep equals its solo ``run_federated_training`` bit
  for bit (history and params), across rules x attacks x seeds, with
  explicit Byzantine masks, an lr-schedule axis and a tail segment,
  streaming and async cells.
* ``structural_key`` groups a spec exactly as the reference's groups
  the same spec.
* The build counter shows one engine build per structural group, and no
  rebuild when only sigma changes.
"""
import numpy as np
import pytest
import torch

import repro_torch.fl.simulator as simulator
from _torch_s5 import LR, cfg, federation, jax_cfg, model, port_data, \
    same_history
from repro.core.attacks import AttackConfig as JaxAttackConfig
from repro.fl.sweep import SweepSpec as JaxSweepSpec
from repro.fl.sweep import group_cells as jax_group_cells
from repro_torch.core.attacks import AttackConfig
from repro_torch.fl import (RoundEngine, SweepSpec, group_cells,
                            run_federated_sweep, run_federated_training,
                            structural_key, trace_counter)
from repro_torch.fl.faults import FaultConfig
from repro_torch.fl.sweep import F_STATIC_RULES, SweepCell
from repro_torch.optim import constant_lr


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


def _solo(c, data, sched=LR):
    return run_federated_training(model(), federation(c, data), c, sched)


def _check_cells(spec, data, sched=LR, **kw):
    fed = federation(spec.base, data)
    with trace_counter() as tc:
        res = run_federated_sweep(model(), fed, spec, sched, **kw)
    cells = spec.cells()
    assert tc.snapshot() == {"build": len(group_cells(cells)), "capture": 0}
    assert len(res) == len(cells)
    for cell, h in zip(cells, res):
        solo = _solo(cell.cfg, data, cell.lr_schedule or sched) \
            if cell.byz_mask is None else None
        if solo is not None:
            assert same_history(h, solo), cell.cfg
    return res, fed


def test_a_grid_equals_its_solo_runs_bitwise(data):
    spec = SweepSpec(base=cfg(rounds=4), seeds=(0, 1),
                     aggregators=("diversefl", "oracle", "mean", "fltrust"),
                     attacks=(AttackConfig("gaussian", sigma=10.0),
                              AttackConfig("gaussian", sigma=300.0),
                              AttackConfig("sign_flip")))
    res, _ = _check_cells(spec, data)
    assert len(res) == 24 and len(group_cells(spec.cells())) == 8
    # the magnitude batches: sigma 10 and 300 share an engine
    assert not same_history(res[0], res[2])


def test_streaming_and_async_cells_equal_their_solo_runs(data):
    base = cfg(aggregator="diversefl", streaming=True, client_chunk=4,
               telemetry=True)
    spec = SweepSpec(base=base, seeds=(0, 2),
                     faults=(FaultConfig(),
                             FaultConfig("straggler", rate=0.3)),
                     stalenesses=(0, 2))
    res, fed = _check_cells(spec, data)
    assert len(res) == 8 and len(group_cells(spec.cells())) == 4
    cells = {e["data"].get("cell") for e in fed.server.audit.entries
             if e["kind"] == "round_tags"}
    assert cells == set(range(8))


def test_an_explicit_mask_axis_batches_with_counts(data):
    n = cfg().n_clients
    mask = np.zeros(n, bool)
    mask[[1, 4, 7]] = True
    spec = SweepSpec(base=cfg(), fs=(2, mask), seeds=(0,))
    cells = spec.cells()
    assert cells[1].cfg.f == 3 and torch.equal(cells[1].byz_mask,
                                               torch.from_numpy(mask))
    assert len(group_cells(cells)) == 1
    fed = federation(spec.base, data)
    res = run_federated_sweep(model(), fed, spec, LR)
    # the masked cell against a solo run whose federation holds that mask
    solo_fed = federation(cells[1].cfg, data)
    solo_fed.byz_mask = torch.from_numpy(mask)
    solo = run_federated_training(model(), solo_fed, cells[1].cfg, LR)
    assert same_history(res[1], solo)
    with pytest.raises(ValueError, match=r"explicit Byzantine mask must be"):
        SweepSpec(base=cfg(), fs=(np.zeros(3, bool),)).cells()


def test_an_lr_axis_and_a_tail_segment(data):
    spec = SweepSpec(base=cfg(rounds=5, eval_every=3), seeds=(1,),
                     lr_schedules=(LR, constant_lr(0.02)))
    res, _ = _check_cells(spec, data)
    assert res[0]["round"] == [3, 5]
    assert not same_history(res[0], res[1])


def test_structural_key_groups_like_the_reference():
    kinds = ("gaussian", "sign_flip")
    port = SweepSpec(
        base=cfg(), seeds=(0, 1), aggregators=("diversefl", "krum", "mean"),
        attacks=tuple(AttackConfig(k, sigma=s) for k in kinds
                      for s in (1.0, 5.0)),
        fs=(1, 2), compressions=("f32", "bf16"))
    jport = JaxSweepSpec(
        base=jax_cfg(cfg()), seeds=(0, 1),
        aggregators=("diversefl", "krum", "mean"),
        attacks=tuple(JaxAttackConfig(k, sigma=s) for k in kinds
                      for s in (1.0, 5.0)),
        fs=(1, 2), compressions=("f32", "bf16"))
    mine = [[i for i, _ in g] for g in group_cells(port.cells()).values()]
    want = [[i for i, _ in g]
            for g in jax_group_cells(jport.cells()).values()]
    assert mine == want and len(mine) == 16


def test_f_is_structure_only_for_the_static_rules():
    assert set(F_STATIC_RULES) == {"trimmed_mean", "krum", "bulyan"}
    assert structural_key(cfg(f=1)) == structural_key(cfg(f=3, seed=9))
    assert structural_key(cfg(aggregator="krum", f=1)) != \
        structural_key(cfg(aggregator="krum", f=3))
    assert structural_key(cfg(attack=AttackConfig("gaussian", sigma=1.0))) \
        == structural_key(cfg(attack=AttackConfig("gaussian", sigma=9.0)))
    assert structural_key(cfg(rounds=4)) != structural_key(cfg(rounds=5))


def test_a_sigma_change_builds_nothing(data):
    c1 = cfg(attack=AttackConfig("gaussian", sigma=10.0))
    c2 = cfg(attack=AttackConfig("gaussian", sigma=500.0))
    fed = federation(c1, data)
    eng = RoundEngine(model(), fed, c1)
    with trace_counter() as tc:
        h = run_federated_training(model(), fed, c2, LR, engine=eng)
    assert tc.snapshot() == {"build": 0, "capture": 0}
    assert same_history(h, _solo(c2, data))
    assert not same_history(h, _solo(c1, data))


def test_empty_axes_and_bad_cells(data):
    assert SweepSpec(base=cfg(), aggregators=()).cells() == []
    fed = federation(cfg(), data)
    assert run_federated_sweep(model(), fed,
                               SweepSpec(base=cfg(), seeds=())) == []
    with pytest.raises(ValueError, match="no learning-rate schedule"):
        run_federated_sweep(model(), fed, SweepSpec(base=cfg()))
    with pytest.raises(ValueError, match="n_clients=7"):
        run_federated_sweep(model(), fed, SweepSpec(base=cfg(n_clients=7)),
                            LR)
    assert isinstance(SweepSpec(base=cfg()).cells()[0], SweepCell)


def test_one_host_sync_per_group(data, monkeypatch):
    calls = []
    real = simulator.host_sync

    def counted(tree):
        calls.append(1)
        return real(tree)
    monkeypatch.setattr(simulator, "host_sync", counted)
    spec = SweepSpec(base=cfg(rounds=3), seeds=(0, 1, 2),
                     aggregators=("diversefl", "mean"))
    run_federated_sweep(model(), federation(spec.base, data), spec, LR)
    assert len(calls) == 2
