"""The comparison that decides ``correct`` rejects its control and every
fault a cell can have, at tiny widths on the CPU under each cell's own
limits: the reference at the next precision below the configuration's
put in the program's place (TF32 for float32, fp8 for bfloat16, both
emulated), and the program with the timed path broken underneath (a
round that leaves the params unchanged, half of each batch left out, a
statistic altered where the kernel produces it, and under a lossy codec
the error feedback dropped).  A cell on one chip has no exchange between
chips to leave out."""
import dataclasses
import time

import pytest

from bench.harness import calibrate, faults, fl, main as hm
from bench.tests._tiny import CELLS, tiny

SEEDS = (101, 202)
# each cell with each fault it can have
PLANTED = [(name, fault) for name in CELLS
           for fault in faults.kinds(tiny(name).traffic)]


def _limits(name):
    return tiny(name).checks["limits"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_sound_program_passes(name, seed):
    cell = tiny(name)
    prog = calibrate.program_outputs(cell, seed, "cpu")
    ref = fl.FLCell(cell, seed, "cpu").reference(prog["states"])
    ok, checks = fl.judge(fl.compare(prog, ref), _limits(name))
    assert ok, checks


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, seed):
    cell = tiny(name)
    states = calibrate.program_outputs(cell, seed, "cpu")["states"]
    run = fl.FLCell(cell, seed, "cpu")
    ref = run.reference(states)
    low = run.reference(states, calibrate.CONTROL[cell.config["dtype"]])
    ok, checks = fl.judge(fl.compare(low, ref), _limits(name))
    assert not ok, checks


@pytest.mark.parametrize("name,fault", PLANTED,
                         ids=[f"{n}-{f}" for n, f in PLANTED])
def test_planted_fault_fails_a_whole_run(name, fault, monkeypatch):
    """The harness's run with the fault planted under the timed path
    (set-up, window, reference, judgement) comes out not correct."""
    cell = tiny(name)
    real = fl.FLCell.__init__

    def with_fault(self, *a, **k):
        real(self, *a, **dict(k, fault=fault))
    monkeypatch.setattr(fl.FLCell, "__init__", with_fault)
    with faults.planted(fault):
        res = hm.run_cell(cell, 303, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_several_local_steps(name):
    """With E = 2 local steps (each client's own params after the first)
    the reference still follows the program within the cell's limits."""
    cell = tiny(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  local_steps=2))
    prog = calibrate.program_outputs(cell, 404, "cpu")
    ref = fl.FLCell(cell, 404, "cpu").reference(prog["states"])
    ok, checks = fl.judge(fl.compare(prog, ref), _limits(name))
    assert ok, checks
