"""A federated cell: set-up, the measured window, the traced window and
the comparison with the plain reference.

The window drives ``repro_torch.fl.engine.RoundEngine.run_training``,
the entry ``run_federated_training`` takes by default, one eval segment
(``eval_every`` rounds, ending in its eval and its one host sync) at a
time.  Set-up makes every input from the seed (data, weights, the
enclave's sample ids, the Byzantine clients, the round generator), builds
the federation and the engine, runs the rounds the reference follows
through that same call, one round a segment, and the cell's warm
segments.  The
program's outputs of those rounds (each round's per-client C1*C2, the
per-leaf norms of the first round's and of all of their moves of the
params) are kept; after the window the program's state is freed and the
reference follows the same rounds from the same inputs.

Under a lossy codec the clients' error-feedback residuals carry from
call to call as they carry through the rounds of one run: each call
hands the engine the params with the residuals the rounds before left.
``run_training`` returns the params alone; an eager run updates the
residual handed in, in place, and a graphed run its captured round's
static copy, which the harness hands back in the next call (the engine
then copies nothing).
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List, Optional

import torch

from bench.harness import faults, seeds, spec
from bench.harness import trace as tr
from bench.reference.fl_round import RoundSpec, diversefl_round
from bench.reference.precision import Precision

# every number a run computes; a cell's workload file names those it
# compares, each with its limit
NUMBERS = ("c1c2_gap", "c1c2_median_gap", "delta1_gap", "change_gap",
           "diff1_gap", "diff1_median_gap")


def memory_peak(dev) -> int:
    """The most device memory the process held since the last
    :func:`reset_memory_peak`, after a sync (0 off the card).  Held, not
    allocated: the segments of a CUDA graph's private pool stay reserved
    for the graph's life, and a replay allocates nothing, so only the
    reserved count sees a graphed round's buffers."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_reserved(dev))


def reset_memory_peak(dev) -> None:
    """Return the cached blocks nothing uses and start a new peak from
    what stays held (live tensors, graph pools)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


class RangedModel:
    """The program's model with its ``grad`` inside a profiler range, so
    the traced run can attribute the model's kernels."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def grad(self, params, batch, l2=0.0):
        with torch.profiler.record_function("bench.model_grad"):
            return self._inner.grad(params, batch, l2)


def leaf_norms(a: Dict, b: Dict) -> Dict[str, float]:
    """Per leaf, ``|a - b|`` of two dicts of the reference's leaves."""
    return {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double()))
            for k in a}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             ref_first: Dict[str, float]) -> float:
    """The worst leaf's ``|prog - ref| / max(ref, median leaf)``.  Leaves
    that the reference's first move leaves at under a thousandth of the
    median leaf's move are left out (round-off moves them alone)."""
    med1 = statistics.median(ref_first.values())
    keep = [k for k in ref if ref_first[k] >= 1e-3 * med1]
    med = statistics.median(ref[k] for k in keep)
    worst = 0.0
    for k in keep:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
        worst = max(worst, g if math.isfinite(g) else math.inf)
    return worst


def diff_gap(prog: Dict, ref: Dict, ref_first: Dict[str, float],
             stat: str = "max") -> float:
    """Per leaf, ``|prog - ref|`` of the two sides' params after the first
    round (the norm of the difference of their moves) over max(the
    reference leaf's first move, the median leaf's), reduced over the
    leaves by ``stat`` (``max`` or ``median``); the leaves ``norm_gap``
    keeps.  A norm of moves is blind, to first order, to rounding errors
    spread over the elements; this is not."""
    med1 = statistics.median(ref_first.values())
    keep = [k for k in ref if ref_first[k] >= 1e-3 * med1]
    gaps = []
    for k in keep:
        a, b = prog[k], ref[k]
        dev = next((t.device for t in (a, b) if t.is_cuda),
                   torch.device("cuda") if torch.cuda.is_available()
                   else a.device)
        d = float(torch.linalg.vector_norm(
            a.to(dev).double() - b.to(dev).double()))
        g = d / max(ref_first[k], med1, 1e-300)
        gaps.append(g if math.isfinite(g) else math.inf)
    return max(gaps) if stat == "max" else statistics.median(gaps)


def c1c2_gaps(prog: List, ref: List, stat: str = "max") -> float:
    """Per round, the clients' ``|prog - ref| / max(|ref|, median |ref|)``
    reduced by ``stat`` (``max``: the worst client; ``median``: the median
    client); the worst round's."""
    worst = 0.0
    for p, r in zip(prog, ref):
        p = torch.as_tensor(p, dtype=torch.float64).cpu()
        r = torch.as_tensor(r, dtype=torch.float64).cpu()
        med = float(r.abs().median())
        d = (p - r).abs() / torch.clamp(r.abs(), min=max(med, 1e-300))
        d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
        v = float(d.max() if stat == "max" else d.median())
        worst = max(worst, v if math.isfinite(v) else math.inf)
    return worst


# what the plain reference models (``bench/reference/fl_round.py``); a
# traffic mix that asks for anything else is refused before set-up rather
# than held against a reference of another round
MODELLED = {"aggregator": ("diversefl",), "compression": ("f32", "int8"),
            "attack": ("sign_flip", "none")}
# every key a traffic file may hold: each is read by the harness or a
# family, and changes the program's round only in ways the reference
# follows (summation order: ``streaming``, ``client_chunk``, ``graph``)
TRAFFIC_KEYS = frozenset({
    "n_clients", "f", "per_client", "seq_len", "batch_size", "local_steps",
    "sample_frac", "root_frac", "lr", "l2", "aggregator", "attack",
    "streaming", "client_chunk", "compression", "graph", "eval_every",
    "n_test"})


def check_modelled(traffic: dict, cfg) -> None:
    """Refuse a traffic mix, or a program's DiverseFL thresholds, that the
    reference's round does not model."""
    unknown = sorted(set(traffic) - TRAFFIC_KEYS)
    if unknown:
        raise ValueError(f"traffic keys {unknown}: nothing in the benchmark "
                         f"reads them, and the reference does not model "
                         f"them")
    for key, allowed in MODELLED.items():
        if traffic[key] not in allowed:
            raise ValueError(f"traffic {key}={traffic[key]!r}: the plain "
                             f"reference models only {allowed}; add a "
                             f"reference for it before a cell uses it")
    ref = RoundSpec(lr=0.0, l2=0.0, local_steps=1)
    got = (cfg.dfl.eps1, cfg.dfl.eps2, cfg.dfl.eps3)
    if got != (ref.eps1, ref.eps2, ref.eps3):
        raise ValueError(f"the program's DiverseFL thresholds {got} are not "
                         f"the reference's {(ref.eps1, ref.eps2, ref.eps3)}")


def wire_groups(prog: dict, leaves: dict) -> tuple:
    """The reference's ``leaves`` as a client's flat update row lays them
    out: one group for each of the program's params ``prog``, in sorted
    name order (the program's ``flatten_updates``), each group's leaves
    in their order inside that param.  ``leaves`` are the family's
    ``from_program`` of ``prog``, views of its params, so each is placed
    by its storage and offset."""
    groups, placed = [], 0
    for name in sorted(prog):
        p = prog[name]
        ptr, lo = p.untyped_storage().data_ptr(), p.storage_offset()
        inside = sorted((v.storage_offset(), k) for k, v in leaves.items()
                        if v.untyped_storage().data_ptr() == ptr
                        and lo <= v.storage_offset() < lo + p.numel())
        if sum(leaves[k].numel() for _, k in inside) != p.numel():
            raise ValueError(f"program param {name!r} is not laid out by "
                             f"the family's leaves (from_program returns "
                             f"no views of it), so the reference cannot "
                             f"lay out its rows as the program's codec "
                             f"does")
        groups.append(tuple(k for _, k in inside))
        placed += len(inside)
    if placed != len(leaves):
        raise ValueError("a leaf of the family's from_program is no view "
                         "of one program param")
    return tuple(groups)


def fl_config(traffic: dict):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.fl.simulator import FLConfig
    T = traffic["eval_every"]
    return FLConfig(
        n_clients=traffic["n_clients"], f=traffic["f"], rounds=T,
        local_steps=traffic["local_steps"], batch_size=traffic["batch_size"],
        l2=traffic["l2"], aggregator=traffic["aggregator"],
        attack=AttackConfig(kind=traffic["attack"]),
        sample_frac=traffic["sample_frac"], root_frac=traffic["root_frac"],
        client_chunk=traffic["client_chunk"], streaming=traffic["streaming"],
        compression=traffic["compression"], eval_every=T)


def draw_ids(traffic: dict, seed: int, device):
    """The enclave's sample ids (N, s), FLTrust's root ids and the
    Byzantine mask (N,): f clients drawn at random."""
    N, n = traffic["n_clients"], traffic["per_client"]
    s = max(1, int(n * traffic["sample_frac"]))
    g = seeds.generator(seed, "enclave", device)
    enclave = torch.rand((N, n), generator=g, device=device).argsort(1)[:, :s]
    n_root = max(1, int(traffic["root_frac"] * N * n))
    root = torch.randperm(N * n, generator=g, device=device)[:n_root]
    gb = seeds.generator(seed, "byzantine", device)
    byz = torch.zeros(N, dtype=torch.bool, device=device)
    byz[torch.randperm(N, generator=gb, device=device)[:traffic["f"]]] = True
    return enclave, root, byz


class FLCell:
    """One run of a federated cell on ``device``."""

    def __init__(self, cell: spec.Cell, seed: int, device, *,
                 ranged: bool = False, fault: Optional[str] = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.fam = spec.family(cell.family)
        self.traffic, self.config = cell.traffic, cell.config
        self.ranged, self.fault = ranged, fault
        self.k = int(cell.checks["checked_rounds"])
        self.warm = int(cell.checks["warm_segments"])
        self.T = int(self.traffic["eval_every"])
        self.cfg = fl_config(self.traffic)
        check_modelled(self.traffic, self.cfg)

    # --- set-up -------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.data.pipeline import FederatedData
        from repro_torch.fl.engine import RoundEngine
        from repro_torch.fl.simulator import (Federation, host_sync,
                                              make_scenario)
        t, dev, fam = self.traffic, self.device, self.fam
        data = fam.make_data(self.config, t, self.seed, dev)
        model = fam.program_model(self.config, t)
        if self.fault == "half_batch":
            model = faults.HalfBatch(model)
        if self.ranged:
            model = RangedModel(model)
        enclave, root, byz = draw_ids(t, self.seed, dev)
        fed = Federation.create(
            model, FederatedData(data["x"], data["y"], data["n_classes"]),
            data["test_x"], data["test_y"], self.cfg, device=dev,
            enclave_idx=enclave, root_idx=root)
        del data
        self.scen = make_scenario(self.cfg, fed, byz_mask=byz)
        p0 = fam.to_program(fam.make_params(self.config, self.seed, dev),
                            model)
        self.engine = RoundEngine(model, fed, self.cfg, graph=t["graph"])
        self.model, self.fed, self.host_sync = model, fed, host_sync
        self.rgen = seeds.generator(self.seed, "rounds", dev)
        lr = float(t["lr"])
        self.lr1 = torch.full((1,), lr, device=dev)
        self.lrT = torch.full((self.T,), lr, device=dev)
        # the clients' residuals under a lossy codec, zero at the start
        self.resid = self.engine.init_carry(p0)[1] if self.engine.lossy \
            else None
        # the rounds the reference follows, one segment each
        self.states, self.c1c2 = [], []
        self.failed_rounds = 0
        p = p0
        for r in range(self.k):
            self.states.append(self.rgen.get_state())
            p, metrics = self.run(p, self.lr1)
            host = host_sync(metrics)
            self.c1c2.append(host["c1c2"][0])
            if r == 0:
                self.norms1 = leaf_norms(fam.from_program(p0, model),
                                         fam.from_program(p, model))
                # kept off the card: the reference later needs its memory
                self.p1 = {k: v.to("cpu", copy=True) for k, v in
                           fam.from_program(p, model).items()}
        self.normsk = leaf_norms(fam.from_program(p0, model),
                                 fam.from_program(p, model))
        del p0
        self.params = p
        for _ in range(self.warm):
            self.segment()

    def run(self, params, lrs):
        """``len(lrs)`` rounds through ``run_training`` from ``params`` and,
        under a lossy codec, the residuals the rounds before left: (the
        new params, the device metrics)."""
        carry = params if self.resid is None else (params, self.resid)
        params, _, metrics, _ = self.engine.run_training(
            carry, self.rgen, lrs, self.scen)
        if self.resid is not None and self.engine.graph:
            captured = getattr(self.engine, "_g", None) or {}
            if "carry" not in captured:
                raise RuntimeError("the engine keeps its captured round's "
                                   "carry under another name: the harness "
                                   "cannot hand the clients' residuals to "
                                   "the next call")
            self.resid = captured["carry"][1]
        return params, metrics

    def segment(self) -> None:
        """One eval segment through the engine and its host sync."""
        self.params, metrics = self.run(self.params, self.lrT)
        host = self.host_sync(metrics)
        if not all(bool(torch.isfinite(torch.as_tensor(v)).all())
                   for v in host.values()):
            self.failed_rounds += self.T

    # --- the windows ------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Whole segments until ``seconds`` have passed: the wall time of
        all of them over all their rounds."""
        self.setup_peak = memory_peak(self.device)
        reset_memory_peak(self.device)
        t0 = time.perf_counter()
        rounds = 0
        while True:
            self.segment()
            rounds += self.T
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        peak = memory_peak(self.device)
        self.rounds = rounds
        return {"round_ms": 1e3 * elapsed / rounds, "peak_bytes": peak,
                "memory_peak_bytes": max(peak, self.setup_peak),
                "seconds": elapsed, "rounds": rounds}

    def traced_window(self, segments: int):
        """``segments`` segments under the profiler, inside the
        ``bench.window`` range, with the program's flight recorder on."""
        from repro_torch.fl import telemetry
        self.setup_peak = memory_peak(self.device)
        ends = []
        with telemetry.recording() as rec, tr.profiled(self.device) as prof:
            with torch.profiler.record_function(tr.WINDOW):
                for _ in range(segments):
                    self.segment()
                    ends.append(len(rec.records))
        self.rounds = segments * self.T
        peak = memory_peak(self.device)
        return tr.read(prof, self.rounds,
                       tr.recorded(rec.records, ends, self.T)), peak

    def finite_params(self) -> bool:
        return all(bool(torch.isfinite(v.float()).all())
                   for v in self.params.values())

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("engine", "fed", "model", "params", "resid", "scen"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ----------------------------------------------------
    def reference(self, states: list, prec: str = "fp32") -> dict:
        """The plain reference over the followed rounds from the same
        inputs, each round's minibatches drawn from the round generator at
        ``states[r]``, the program's draw at that round: {"c1c2": [...],
        "norms1": {...}, "p1": {...}, "normsk": {...}, "resid": the
        clients' residuals after them (None without a lossy codec)}."""
        t, dev, fam = self.traffic, self.device, self.fam
        data = fam.make_data(self.config, t, self.seed, dev)
        enclave, _, byz = draw_ids(t, self.seed, dev)
        ref = fam.reference(self.config)
        params = fam.make_params(self.config, self.seed, dev)
        p0 = fam.leaves(params)
        N, E, m = t["n_clients"], t["local_steps"], t["batch_size"]
        rows = torch.arange(N, device=dev)[:, None]
        gx, gy = data["x"][rows, enclave], data["y"][rows, enclave]
        rs = RoundSpec(lr=float(t["lr"]), l2=float(t["l2"]), local_steps=E,
                       attack=t["attack"])
        feat = tuple(data["x"].shape[2:])
        codec = {"codec": t["compression"]}
        if t["compression"] != "f32":
            model = fam.program_model(self.config, t)
            prog = fam.to_program(params, model)
            wire = wire_groups(prog, fam.from_program(prog, model))
            d = sum(p.numel() for p in prog.values())
            del model, prog
            codec.update(wire=wire, resid=torch.zeros((N, d), device=dev))
        p, c1c2, norms1 = p0, [], None
        for r in range(self.k):
            g = torch.Generator(device=dev)
            g.set_state(states[r])
            idx = torch.randint(0, t["per_client"], (N, E * m), generator=g,
                                device=dev)
            xs = data["x"][rows, idx].reshape((N, E, m) + feat)
            ys = data["y"][rows, idx].reshape(N, E, m)
            p, c, _ = diversefl_round(ref, p, xs, ys, gx, gy, byz, rs,
                                      Precision(prec), **codec)
            c1c2.append(c.cpu())
            if r == 0:
                norms1, p1 = leaf_norms(p0, p), p
        return {"c1c2": c1c2, "norms1": norms1, "p1": p1,
                "normsk": leaf_norms(p0, p), "resid": codec.get("resid")}

    def program_outputs(self) -> dict:
        return {"c1c2": self.c1c2, "norms1": self.norms1, "p1": self.p1,
                "normsk": self.normsk, "states": self.states}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of a run."""
    return {"c1c2_gap": c1c2_gaps(prog["c1c2"], ref["c1c2"]),
            "c1c2_median_gap": c1c2_gaps(prog["c1c2"], ref["c1c2"],
                                         "median"),
            "delta1_gap": norm_gap(prog["norms1"], ref["norms1"],
                                   ref["norms1"]),
            "change_gap": norm_gap(prog["normsk"], ref["normsk"],
                                   ref["norms1"]),
            "diff1_gap": diff_gap(prog["p1"], ref["p1"], ref["norms1"]),
            "diff1_median_gap": diff_gap(prog["p1"], ref["p1"],
                                         ref["norms1"], "median")}


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names: each at or under its limit; a limit not set yet fails."""
    checks, ok = {}, bool(limits)
    for k, lim in limits.items():
        v = numbers[k]
        checks[k] = {"value": v, "limit": lim}
        if lim is None or not (v <= lim):
            ok = False
    return ok, checks
