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
    ("compression", "bf16"), ("attack", "gaussian")])
def test_an_unmodelled_round_is_refused(key, value):
    cell = tiny("mlp3-xdevice")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **{key: value}))
    with pytest.raises(ValueError, match=f"traffic {key}="):
        fl.FLCell(cell, 1, "cpu")


@pytest.mark.parametrize("streaming", [False, True])
def test_int8_is_modelled_where_the_family_states_its_wire(streaming):
    """The int8 uplink is modelled, streamed or dense, for every family:
    the harness reads the leaves' order on the wire from the family's
    own map (``from_program``'s leaves are views of the program's
    params), one group a program param, its leaves in their place.  A map
    that gives no views is refused."""
    for name in ("mlp3-xdevice", "danube-silo"):
        cell = tiny(name)
        t = dict(cell.traffic, compression="int8", streaming=streaming)
        fl.check_modelled(t, fl.fl_config(t))
        fam = spec.family(cell.family)
        model = fam.program_model(cell.config, t)
        prog = fam.to_program(fam.make_params(cell.config, 1, "cpu"), model)
        leaves = fam.from_program(prog, model)
        wire = fl.wire_groups(prog, leaves)
        assert sorted(k for grp in wire for k in grp) == sorted(leaves)
        for grp, key in zip(wire, sorted(prog)):
            assert sum(leaves[k].numel() for k in grp) == prog[key].numel()
    wq = sorted(prog).index(next(k for k in prog if k.endswith("attn/wq")))
    assert wire[wq] == tuple(f"wq.{i}"
                             for i in range(cell.config["n_layers"]))
    copies = {k: v.clone() for k, v in leaves.items()}
    with pytest.raises(ValueError, match="lay out"):
        fl.wire_groups(prog, copies)


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
