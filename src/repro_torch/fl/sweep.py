"""Experiment sweeps: a grid of federated runs, one engine per structural
group.

The paper's results are grids (attack x Byzantine count x rule x seed).
Run one by one, each cell builds its own round body and, with a CUDA
graph, captures its own round.  This module groups them:

  * :class:`SweepSpec`: a grid of per-cell values over a base
    ``FLConfig`` (seeds, Byzantine counts or masks, attack configs whose
    sigma/scale are data, learning-rate schedules, participation levels,
    pods, codecs, fault models, staleness buffers).  ``cells()`` is the
    cartesian product, seeds innermost, so cells of one structure sit
    together.
  * :func:`structural_key`: everything that shapes the round (rule,
    attack kind and class targets, participation, rounds, chunking,
    thresholds, faults, ...) splits groups; what is data (seed, attack
    magnitudes, the Byzantine mask, and ``f`` for every rule outside
    :data:`F_STATIC_RULES`) does not.
  * :func:`execute_sweep`: each group runs on **one**
    ``RoundEngine``, built once (and with ``graph=True`` captured once);
    each cell copies its init params, generator seed, lr vector and
    scenario operands (:func:`~repro_torch.fl.simulator.make_scenario`)
    into the engine and runs.  The cells' device metrics leave the card
    with one host sync per group.

The reference vmaps a group into one program.  The port runs the cells
of a group one after the other on the same engine: its CUDA kernels are
not vmappable, and a cell equals its solo run bit for bit either way.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Callable, Optional, Sequence

import torch

from ..core.attacks import AttackConfig
from . import simulator as _sim
from . import telemetry
from .engine import RoundEngine, trace_counter
from .faults import FaultConfig
from .simulator import (FLConfig, _empty_history, _lr_vector, _record_eval,
                        eval_row, make_scenario)

# Rules that take the Byzantine budget ``f`` as structure (trims, neighbour
# counts): for them ``f`` splits groups.  Every other rule sees Byzantine
# identity only through the scenario mask, so ``f`` is data.
F_STATIC_RULES = ("trimmed_mean", "krum", "bulyan")


@dataclasses.dataclass(frozen=True, eq=False)
class SweepCell:
    """One grid point: a full config plus its non-config operands."""
    cfg: FLConfig
    lr_schedule: Optional[Callable] = None    # None -> the sweep default
    byz_mask: Optional[torch.Tensor] = None   # None -> derive from cfg.f


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A grid of federated runs over a base config.  Each axis is
    optional (``None`` keeps the base value; an empty sequence yields no
    cells).  ``fs`` entries are Byzantine counts or explicit (N,) masks;
    ``attacks`` whole ``AttackConfig``s (kinds and class targets are
    structure, sigma/scale data); ``pods``, ``compressions``, ``faults``
    and ``stalenesses`` are structural.  The product runs in the
    declaration order below with ``seeds`` innermost, and ``cells()[i]``
    maps to result i of ``run_federated_sweep``."""
    base: FLConfig
    seeds: Sequence[int] = (0,)
    aggregators: Optional[Sequence[str]] = None
    attacks: Optional[Sequence[AttackConfig]] = None
    fs: Optional[Sequence] = None             # ints or explicit (N,) masks
    participations: Optional[Sequence[float]] = None
    pods: Optional[Sequence[Optional[int]]] = None
    compressions: Optional[Sequence[str]] = None
    faults: Optional[Sequence[FaultConfig]] = None
    stalenesses: Optional[Sequence[int]] = None
    lr_schedules: Optional[Sequence[Callable]] = None

    def cells(self) -> list:
        def axis(values, default):
            return values if values is not None else (default,)

        b = self.base
        out = []
        for agg in axis(self.aggregators, b.aggregator):
            for atk in axis(self.attacks, b.attack):
                for f in axis(self.fs, b.f):
                    for part in axis(self.participations, b.participation):
                        for pod in axis(self.pods, b.pods):
                            for comp in axis(self.compressions,
                                             b.compression):
                                for flt in axis(self.faults, b.fault):
                                    for stal in axis(self.stalenesses,
                                                     b.staleness_buffer):
                                        for sched in axis(
                                                self.lr_schedules, None):
                                            for seed in self.seeds:
                                                out.append(self._cell(
                                                    agg, atk, f, part, pod,
                                                    comp, flt, stal, sched,
                                                    seed))
        return out

    def _cell(self, agg, atk, f, part, pod, comp, flt, stal, sched, seed):
        mask = None
        if isinstance(f, numbers.Integral):
            fi = int(f)
        else:
            mask = torch.as_tensor(f, dtype=torch.bool)
            if tuple(mask.shape) != (self.base.n_clients,):
                raise ValueError(
                    f"explicit Byzantine mask must be "
                    f"({self.base.n_clients},), got {tuple(mask.shape)}")
            fi = int(mask.sum())
        cfg = dataclasses.replace(
            self.base, aggregator=agg, attack=atk, f=fi,
            participation=part, pods=pod, compression=comp,
            fault=flt, staleness_buffer=stal, seed=seed)
        return SweepCell(cfg, sched, mask)


def structural_key(cfg: FLConfig):
    """The structure of a config: two cells share an engine iff their keys
    are equal.  It erases the data fields (seed, the attack magnitudes,
    and ``f`` outside :data:`F_STATIC_RULES`) and keeps the rest of the
    frozen config, so a new FLConfig field is structural by default."""
    return dataclasses.replace(
        cfg, seed=0,
        f=cfg.f if cfg.aggregator in F_STATIC_RULES else 0,
        attack=dataclasses.replace(cfg.attack, sigma=0.0, scale=0.0))


def group_cells(cells: Sequence[SweepCell]):
    """Partition cells into structural groups, preserving cell order:
    ``{structural_key: [(cell_index, cell), ...]}``."""
    groups = {}
    for i, cell in enumerate(cells):
        groups.setdefault(structural_key(cell.cfg), []).append((i, cell))
    return groups


def execute_sweep(model, fed, spec: SweepSpec,
                  lr_schedule: Optional[Callable] = None,
                  log_every: int = 0, graph: bool = False) -> list:
    """Run every cell of ``spec``, one engine per structural group; returns
    the per-cell histories in ``spec.cells()`` order (the body of
    ``fl.simulator.run_federated_sweep``)."""
    cells = spec.cells()
    if not cells:
        return []
    for cell in cells:
        if cell.cfg.n_clients != fed.data.n_clients:
            raise ValueError(
                f"sweep cell has n_clients={cell.cfg.n_clients} but the "
                f"federation holds {fed.data.n_clients} clients")
        if cell.cfg.rounds < 1:
            raise ValueError("sweep cells need rounds >= 1")
        if cell.lr_schedule is None and lr_schedule is None:
            raise ValueError(
                "no learning-rate schedule: pass lr_schedule= or give "
                "the spec an lr_schedules axis")
    dev = fed.device
    results = [None] * len(cells)
    for gi, members in enumerate(group_cells(cells).values()):
        rep = members[0][1].cfg                # structural representative
        with telemetry.span("sweep_group", group=gi, cells=len(members),
                            aggregator=rep.aggregator,
                            attack=rep.attack.kind, rounds=rep.rounds,
                            codec=rep.compression,
                            streaming=bool(rep.streaming)), \
                trace_counter() as builds, torch.no_grad():
            engine = RoundEngine(model, fed, rep, graph=graph)
            runs = []
            for _, c in members:
                gen = torch.Generator(device=dev).manual_seed(c.cfg.seed)
                params = model.init(torch.Generator(device=dev).manual_seed(
                    c.cfg.seed + 1), dev)
                lrs = _lr_vector(c.lr_schedule or lr_schedule, rep.rounds,
                                 dev)
                runs.append((params, gen, lrs,
                             make_scenario(c.cfg, fed, byz_mask=c.byz_mask)))
            params, metrics, eval_rounds = engine.run_training_sweep(runs)
            telemetry.event("sweep_group_builds", group=gi,
                            **builds.snapshot())
        # THE host sync, one per group; looked up through the module so a
        # counter wrapped around simulator.host_sync sees it
        host = _sim.host_sync(metrics)
        d = sum(v.numel() for v in params[0].values())
        for g, (idx, cell) in enumerate(members):
            hist = _empty_history()
            tel_host = host[g].pop("_tel", None)
            for s, r in enumerate(eval_rounds):
                _record_eval(hist, r, eval_row(host[g], s), log_every)
            hist["final_acc"] = hist["acc"][-1] if hist["acc"] \
                else float("nan")
            hist["params"] = params[g]
            hist["streaming_fallback"] = engine.streaming_fallback
            cstats = _sim.comm_stats(cell.cfg, d)
            hist.update(cstats)
            if tel_host is not None:
                _sim.drain_round_telemetry(
                    fed.server, tel_host,
                    uplink_bytes=cstats["uplink_bytes_per_round"], cell=idx)
            results[idx] = hist
    return results
