"""A traffic mix is run only where the plain reference models its round:
any other rule, codec, attack, threshold or traffic key is refused before
set-up, not held against the wrong reference."""
import dataclasses

import pytest

from bench.harness import fl, spec
from bench.tests._tiny import CELLS, tiny



@pytest.mark.parametrize("name", CELLS)
def test_the_cells_are_modelled(name):
    cell = tiny(name)
    fl.check_modelled(cell.traffic, fl.fl_config(cell.traffic))


@pytest.mark.parametrize("key,value", [
    ("aggregator", "fltrust"), ("aggregator", "mean"),
    ("compression", "int8"), ("compression", "bf16"),
    ("attack", "gaussian")])
def test_an_unmodelled_round_is_refused(key, value):
    cell = tiny("mlp3-xdevice")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **{key: value}))
    with pytest.raises(ValueError, match=f"traffic {key}="):
        fl.FLCell(cell, 1, "cpu")


def test_a_key_nothing_reads_is_refused():
    cell = tiny("mlp3-xdevice")
    cell = dataclasses.replace(
        cell, traffic=dict(cell.traffic, partition="iid"))
    with pytest.raises(ValueError, match="partition"):
        fl.FLCell(cell, 1, "cpu")


def test_other_thresholds_are_refused():
    from repro_torch.core.diversefl import DiverseFLConfig
    t = spec.load_cell("mlp3-xdevice").traffic
    cfg = dataclasses.replace(fl.fl_config(t), dfl=DiverseFLConfig(eps2=0.25))
    with pytest.raises(ValueError, match="thresholds"):
        fl.check_modelled(t, cfg)
