"""The round engine: a whole federated run with one host sync, optionally
replayed from a CUDA graph.

The per-round loop (``run_federated_training(use_engine=False)``) reads
every eval point's metrics on the host, which waits on the card each
time.  The engine runs the same round body (``fl/simulator.make_round_body``)
round after round without reading anything back: the learning rates are
one (R,) device vector, each eval point's metrics are written into
preallocated (evals, ...) device buffers, the per-round telemetry block
into (rounds,) buffers, and the caller fetches them all with one
``simulator.host_sync``.  The engine's history and params equal the
per-round loop's bit for bit.

Each eval point enters the ``eval`` and ``handoff`` phases
(``fl/telemetry.phase``) after the rounds' own four.  While
``torch.profiler`` records, the host ranges ``fl.run_training`` (each
:meth:`RoundEngine.run_training`) and ``fl.replay`` (each graph replay)
name the host's work.

``graph=True`` (off by default) captures one round in a
``torch.cuda.CUDAGraph``: the carry, the error-feedback residuals, the
async slab, the learning-rate vector with a device round counter, the
scenario operands and the telemetry buffers are static tensors, and the
run's generator is registered with the graph, so each replay draws the
numbers an eager round would.  A run copies its carry, scenario, lrs and
generator state into the static tensors and replays the graph once per
round; eval points run eagerly on the static carry between replays.
The round's phase marks are nodes of the graph.  One capture serves
every run of the engine whose shapes match (a sweep's structural group).
The graph needs a CUDA device, and a capture that fails raises: nothing
falls back to eager rounds.

``mesh=`` (default: the active ``sharding.get_mesh()``) runs the same
rounds on a client x model ``DeviceMesh`` (``sharding/api.py``): each data
rank folds its own client blocks and the partial states are gathered
(``fl/streaming.py``); where a round splits over the data ranks
(``sharding.client_split``: a model axis of 1 and client rows the ranks
tile) each rank builds only its rows of the segment stacks and computes
only their Steps 2-3, and the dense round gathers the update rows and
the Step 4 statistics in client order (``fl/simulator.make_round_body``);
on a model axis > 1 the carry holds the rank's tiles of the params
(``sharding.place_params``, once, on the engine's own mesh), every
client's update is computed split over the model group, and
the federated state is the rank's row of the blocked (ms, L) layout.  So
is the carry's: under a lossy codec the rank holds columns
``[s·L, (s+1)·L)`` of the (N, D) error-feedback residual plane (the
reference's plane, flat in blocked element order; lossy codecs need
pad-free leaves, so ms·L == D), and in async rounds row ``s`` of the
(B, ms, L) staleness slab, a (B, L) tensor.  The layout is the engine's
own mesh's, whatever mesh is active when the carry is built.  A 1 x 1
mesh is the meshless run: no collective, bit for bit.  A data-axis mesh
is bitwise the meshless run (a streaming one with ``stream_shards`` equal
to its rank count); a model axis > 1 agrees to fp tolerance (the
criterion statistics sum shard partials, and the split layers sum
partial products), and every
rank of a model group returns the same whole params
(``sharding.gather_params``, once a run).
"""
from __future__ import annotations

import contextlib
import logging
from typing import Optional

import torch

from ..sharding.api import (blocked_layout, gather_clients, gather_params,
                            get_mesh, model_index, model_shard_count,
                            place_params, sweep_put, use_mesh)
from . import telemetry
from .faults import init_async_state
from .metrics import make_eval_fn
from .simulator import make_round_body, make_scenario

logger = logging.getLogger(__name__)

__all__ = ["RoundEngine", "make_round_body", "make_scenario",
           "trace_counter", "trace_counts", "TRACE_COUNTS"]


# ----------------------------------------------------------------------
# Build and capture counters
# ----------------------------------------------------------------------

# Counted, not inferred: ``build`` goes up once per RoundEngine (one round
# body built), ``capture`` once per CUDA-graph capture of a round.  The
# sweep reads them to show one build (one capture) per structural group.
TRACE_COUNTS = {"build": 0, "capture": 0}


def trace_counts():
    """A snapshot of the engine's build and capture counters."""
    return dict(TRACE_COUNTS)


class TraceDelta:
    """Live view of the counters since a :func:`trace_counter` entry:
    ``delta["build"]`` reads the current delta, inside or after the
    ``with`` block."""

    def __init__(self, start):
        self._start = start

    def __getitem__(self, kind):
        return TRACE_COUNTS[kind] - self._start.get(kind, 0)

    def snapshot(self):
        return {k: self[k] for k in TRACE_COUNTS}

    def total(self):
        return sum(self.snapshot().values())


@contextlib.contextmanager
def trace_counter():
    """``with trace_counter() as tc:`` yields a :class:`TraceDelta`
    relative to the entry; the global counters keep counting."""
    yield TraceDelta(dict(TRACE_COUNTS))


def _copy_tree(dst, src):
    """Copy ``src``'s tensors into ``dst``'s, leaf by leaf (same
    structure); a leaf that is the same tensor is left alone."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_tree(a, b)
    elif dst is not None and dst is not src:
        dst.copy_(src)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return None if tree is None else tree.clone()


class _Buffers:
    """Preallocated device buffers with a leading (rows,) axis, one per key,
    allocated on first write from the value's shape and dtype."""

    def __init__(self, rows: int):
        self.rows, self.buf = rows, {}

    def put(self, row: int, values: dict) -> None:
        for k, v in values.items():
            b = self.buf.get(k)
            if b is None:
                b = self.buf[k] = v.new_empty((self.rows,) + tuple(v.shape))
            b[row].copy_(v)


class RoundEngine:
    """Federated rounds with one host sync per run.

    ``run_segment(carry, generator, lrs)`` runs ``len(lrs)`` rounds and
    returns ``(carry, last_logs)``, the final round's logs being what an
    eval point reads.  ``run_training(carry, generator, lrs)`` runs a whole
    run: every ``eval_every``-th round (and the last) evaluates into device
    buffers, and it returns ``(params, generator, metrics, eval_rounds)``,
    ``metrics`` a dict of (evals, ...) device tensors (with the reserved
    key ``"_tel"``, the (rounds,) telemetry block, when ``cfg.telemetry``
    is on) that the caller fetches with one host sync.
    ``run_training_sweep`` runs a structural group of cells on this one
    engine (``fl/sweep.py``).  The generator advances in place, exactly as
    the per-round loop advances it.

    ``batch_mode``: ``"inline"`` (the default) draws each round's
    minibatches in the round; ``"segment"`` draws a segment's stack first
    (``FederatedData.segment_minibatches``).  With one stateful generator
    the two agree bitwise only when a round draws nothing but its
    minibatches, so ``"segment"`` refuses a config whose rounds draw more
    (participation < 1, gaussian noise, fault rows, resampling).

    The eval cadence and the client blocks are ``cfg.eval_every`` and
    ``cfg.client_chunk``; a caller that needs others passes
    ``dataclasses.replace(cfg, ...)``.  The port has no buffer donation:
    every round allocates its new carry and leaves the caller's tensors
    untouched, and ``FLConfig(donate=True)`` is refused by name.  The graph
    updates its own static carry in place.

    ``graph=True`` replays a captured round (module docstring).  The
    counters show the capture: :data:`TRACE_COUNTS` ``["capture"]``, and
    ``captured_launches`` holds the kernel launches made while capturing,
    which every replay repeats (``replays`` counts them).

    ``mesh`` (a ``DeviceMesh``; default ``sharding.get_mesh()``) runs the
    rounds on the client x model mesh, every rank of it calling the same
    methods; ``batch_mode`` then defaults to ``"segment"`` where the
    config allows it.  ``model_shards`` is the mesh's model-axis size.
    The first run on a model axis > 1 checks the config
    (``FLConfig.validate_model_sharding``: streaming, no kernel flags,
    and for a lossy codec pad-free leaves and QBLOCK | D/ms).  There the
    carry holds the rank's tiles: whole params handed in are placed
    (``sharding.place_params``), and ``run_training`` returns the whole
    params (``sharding.gather_params``).  A model axis > 1 takes every
    codec and async
    round the check admits: the carry holds the rank's (N, L) residual
    columns or (B, L) slab row (:meth:`init_carry`), and ``run_segment``
    returns them.  ``graph=True`` on a mesh of more than one rank is
    refused by name.
    """

    def __init__(self, model, fed, cfg, *, batch_mode: Optional[str] = None,
                 mesh=None, graph: bool = False):
        from torch.distributed.device_mesh import DeviceMesh
        self.mesh = mesh if mesh is not None else get_mesh()
        if self.mesh is not None and not isinstance(self.mesh, DeviceMesh):
            raise TypeError(
                f"RoundEngine(mesh=...) takes a torch.distributed "
                f"DeviceMesh (launch.mesh.make_host_mesh), got "
                f"{type(self.mesh).__name__}")
        self.model_shards = model_shard_count(self.mesh)
        if graph and self.mesh is not None and self.mesh.size() > 1:
            raise NotImplementedError(
                f"RoundEngine(graph=True) on a mesh of {self.mesh.size()} "
                f"ranks: a captured round would have to capture its "
                f"collectives, which needs NCCL, and NCCL holds one rank a "
                f"card; gloo stages CUDA tensors through the host, which a "
                f"CUDA graph cannot capture.  It waits for a machine with "
                f"at least two cards (ROADMAP queue 3); a 1 x 1 mesh "
                f"captures, or run eager rounds")
        self._model_sharding_checked = False
        self._like = None       # the whole params' shapes, on a split
        self.model, self.fed, self.cfg = model, fed, cfg
        self.device = fed.device
        self.eval_every = cfg.eval_every
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got "
                             f"{self.eval_every}")
        if batch_mode is None:
            batch_mode = "segment" if (self.mesh is not None and not
                                       _draws_beyond_batches(cfg)) \
                else "inline"
        if batch_mode not in ("inline", "segment"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        if batch_mode == "segment" and _draws_beyond_batches(cfg):
            raise ValueError(
                f"batch_mode='segment' draws a segment's minibatches ahead "
                f"of its rounds from the run's one generator, which equals "
                f"the inline draws only when a round draws nothing else; "
                f"this config also draws {_draws_beyond_batches(cfg)}")
        self.batch_mode = batch_mode
        if graph and self.device.type != "cuda":
            raise ValueError(
                f"RoundEngine(graph=True) captures a CUDA graph and needs a "
                f"CUDA device; the federation lives on {self.device}")
        self.graph = graph
        TRACE_COUNTS["build"] += 1
        self._body = make_round_body(model, fed, cfg)
        self.streaming = self._body.streaming
        self.streaming_fallback = self._body.streaming_fallback
        self.lossy = self._body.lossy
        self.async_mode = self._body.async_mode
        self.telemetry = bool(cfg.telemetry)
        self._tel_fn = telemetry.make_round_telemetry_fn(cfg) \
            if self.telemetry else None
        self.default_scenario = make_scenario(cfg, fed)
        self._eval_fn = make_eval_fn(model, fed, cfg)
        self._g = None                        # the captured round, if any
        self.captured_launches = None
        self.replays = 0

    # --- the carry ------------------------------------------------------
    def eval_metrics(self, params, logs):
        """The device metric dict of one eval point."""
        with use_mesh(self.mesh):
            return self._eval_fn(params, logs)

    def init_carry(self, params):
        """The round carry for ``params``: bare params; ``(params,
        zeros(N, w))`` under a lossy codec; ``(params, async state)`` in
        async rounds, its slab (B, w).  ``w`` is D, or on a model axis > 1
        the blocked layout's row width L of the engine's own mesh (never
        the mesh active at the call), and the params are the rank's
        tiles."""
        return self._init_carry(params, self.model_shards)

    def _placed(self, params, ms):
        """The rank's tiles of ``params`` on a model axis ``ms`` > 1: whole
        params (the first ones seen fix the whole shapes) are placed on
        the engine's own mesh, tiles pass."""
        if ms <= 1:
            return params
        if self._like is None:
            self._like = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device="meta")
                          for k, v in params.items()}
        if all(v.shape == self._like[k].shape for k, v in params.items()):
            return place_params(params, self.mesh)
        return params

    def whole_params(self, params):
        """The whole params from a carry's (the engine's mesh's tiles on a
        model axis > 1: one ``all_gather`` a tiled leaf)."""
        if self.model_shards <= 1 or self._like is None:
            return params
        with use_mesh(self.mesh):
            return gather_params(params, self._like, self.mesh)

    def _init_carry(self, params, ms):
        params = self._placed(params, ms)
        if not (self.lossy or self.async_mode):
            return params
        w = blocked_layout(self._like, ms).L if ms > 1 \
            else sum(v.numel() for v in params.values())
        if self.lossy:
            return params, torch.zeros((self.cfg.n_clients, w),
                                       dtype=torch.float32,
                                       device=self.device)
        return params, init_async_state(self.cfg, (w,), self.device)

    def carry_params(self, carry):
        """The params inside a carry."""
        return carry[0] if (self.lossy or self.async_mode) else carry

    def _ensure_carry(self, carry, ms):
        """Bare params where a carry is expected start a fresh run.  On a
        model axis > 1 a whole (N, D) residual plane, in blocked element
        order (the reference's layout; the ranks' columns side by side),
        is cut to this rank's (N, L) columns."""
        if not (self.lossy or self.async_mode) or isinstance(carry, dict):
            return self._init_carry(carry, ms)
        if ms <= 1:
            return carry
        carry = (self._placed(carry[0], ms),) + tuple(carry[1:])
        if not self.lossy:
            return carry
        params, resid = carry
        L = blocked_layout(self._like, ms).L
        if resid.shape[-1] == ms * L:
            s = model_index(self.mesh)
            resid = resid[:, s * L:(s + 1) * L].clone()
        return params, resid

    def _prepare_carry(self, carry, ms):
        """:meth:`_ensure_carry`, and on a model axis > 1 the config check
        (named errors, once)."""
        carry = self._ensure_carry(carry, ms)
        if ms > 1 and not self._model_sharding_checked:
            self._check_model_sharding(self.carry_params(carry))
        return carry

    def _check_model_sharding(self, params):
        leaves = list(self._like.values())
        self.cfg.validate_model_sharding(
            sum(p.numel() for p in leaves), self.model_shards,
            streaming_fallback=self.streaming_fallback,
            leaf_sizes=tuple(p.numel() for p in leaves))
        self._model_sharding_checked = True

    # --- eager rounds ---------------------------------------------------
    def _round(self, carry, lr, generator, scen, draws, i, batch):
        kw = {} if draws is None else {k: v[i] for k, v in draws.items()}
        return self._body(carry, lr, generator, scen=scen, batch=batch,
                          like=self._like, **kw)

    def _segments(self, R):
        """(start, length) of each eval segment of an R-round run."""
        T = self.eval_every
        return [(s, min(T, R - s)) for s in range(0, R, T)]

    def _segment_batches(self, n, generator, draws, start):
        """A segment's minibatch stacks: on a round that splits over the
        data ranks (the body's ``client_rows``, under the active mesh)
        only this rank's rows, unless the draws inject the selection;
        else all N."""
        if self.batch_mode != "segment":
            return None
        draws = draws or {}
        idx = None if "batch_idx" not in draws \
            else draws["batch_idx"][start:start + n]
        rows = None if "sel" in draws else self._body.client_rows()
        return self.fed.data.segment_minibatches(
            n, self.cfg.local_steps * self.cfg.batch_size, generator,
            idx=idx, rows=rows)

    @torch.no_grad()
    def run_segment(self, carry, generator, lrs, scen=None, draws=None):
        """Run ``len(lrs)`` rounds eagerly; returns ``(carry, last_logs)``.
        ``draws`` maps body draw names (``batch_idx``, ``sel``, ``noise``,
        ``fault_rows``, ...) to per-round stacks, indexed from the
        segment's first round."""
        if scen is None:
            scen = self.default_scenario
        carry = self._prepare_carry(carry, self.model_shards)
        n = int(lrs.shape[0])
        with use_mesh(self.mesh):
            stack = self._segment_batches(n, generator, draws, 0)
            logs = None
            for t in range(n):
                batch = None if stack is None else (stack[0][t],
                                                    stack[1][t])
                carry, logs = self._round(carry, lrs[t], generator, scen,
                                          draws, t, batch)
        return carry, logs

    @torch.no_grad()
    def run_training(self, carry, generator, lrs, scen=None, draws=None):
        """Run ``len(lrs)`` rounds with the metrics kept on the device.

        Returns ``(params, generator, metrics, eval_rounds)``: ``metrics``
        maps each eval key to an (evals, ...) device tensor (plus
        ``"_tel"`` with telemetry on), ``eval_rounds`` the host list of the
        rounds each row was evaluated at.  Nothing is read on the host.
        On a mesh every rank calls it and gets the same full params and
        metrics: on a model axis > 1 the tiles are gathered once, at the
        end."""
        with use_mesh(self.mesh), telemetry.profiled("fl.run_training"):
            params, generator, metrics, rounds = self._run_training(
                carry, generator, lrs, scen, draws, self.model_shards)
        return self.whole_params(params), generator, metrics, rounds

    def _run_training(self, carry, generator, lrs, scen, draws, ms):
        """The run on the active mesh, whose model axis is ``ms``: the
        engine's own, or 1 for a sweep's cells, which run off-mesh."""
        if scen is None:
            scen = self.default_scenario
        R = int(lrs.shape[0])
        segs = self._segments(R)
        eval_rounds = [s + n for s, n in segs]
        if self.graph:
            if draws is not None:
                raise ValueError("RoundEngine(graph=True) replays its own "
                                 "draws; injected draws need graph=False")
            params, metrics, tel = self._run_graph(carry, generator, lrs,
                                                   scen, len(segs))
        else:
            carry = self._prepare_carry(carry, ms)
            bufs, tbufs = _Buffers(len(segs)), _Buffers(R)
            for e, (start, n) in enumerate(segs):
                stack = self._segment_batches(n, generator, draws, start)
                for t in range(n):
                    i = start + t
                    batch = None if stack is None \
                        else (stack[0][t], stack[1][t])
                    carry, logs = self._round(carry, lrs[i], generator,
                                              scen, draws, i, batch)
                    if self._tel_fn is not None:
                        tbufs.put(i, self._tel_fn(logs))
                self._evaluate(bufs, e, self.carry_params(carry), logs)
            params, metrics, tel = self.carry_params(carry), bufs.buf, \
                tbufs.buf
        if self.telemetry and tel:
            metrics = dict(metrics, _tel=tel)
        return params, generator, metrics, eval_rounds

    def _evaluate(self, bufs, e, params, logs):
        """Eval point ``e`` into ``bufs``: the ``eval`` phase, then the
        ``handoff`` phase from the copy into the run's buffers on.  The
        device's time from that mark to the next round's first mark is the
        segment edge's: the copies out, the host sync, the next segment's
        copies in, its generator state and its learning rates."""
        with telemetry.phase("eval", self.device):
            values = self._eval_fn(params, logs)
        with telemetry.phase("handoff", self.device):
            bufs.put(e, values)

    # --- the sweep axis -------------------------------------------------
    def run_training_sweep(self, cells):
        """Run a structural group of cells on this engine, one after the
        other; ``cells`` yields ``(params, generator, lrs, scen)`` per cell.
        Returns ``(params_list, metrics_list, eval_rounds)``: each cell's
        final params and device metric dict (fetch them together with one
        host sync).  A cell equals its solo ``run_training`` bitwise.

        On a mesh the cells are placed over the data ranks
        (``sharding.sweep_put``): each rank runs its contiguous share, each
        cell off-mesh, one after another, and the params and metrics are
        gathered over the client group in cell order, so every rank
        returns the meshless sweep's results bit for bit.  A group whose
        size does not tile the data ranks runs whole on every rank."""
        cells = list(cells)
        G = len(cells)
        with use_mesh(self.mesh):
            mine = sweep_put(torch.arange(G)).tolist()
        params_out, metrics_out, eval_rounds = [], [], None
        with use_mesh(None):
            for i in mine:
                params, generator, lrs, scen = cells[i]
                p, _, m, eval_rounds = self._run_training(
                    params, generator, lrs, scen, None, 1)
                params_out.append(p)
                metrics_out.append(m)
        if len(mine) == G:
            return params_out, metrics_out, eval_rounds

        def gathered(*xs):
            return list(gather_clients(torch.stack(xs), self.mesh).unbind(0))
        params_out = _unstack(_zip_map(gathered, params_out), G)
        metrics_out = _unstack(_zip_map(gathered, metrics_out), G)
        return params_out, metrics_out, eval_rounds

    # --- the CUDA graph -------------------------------------------------
    def _capture(self, carry, generator, scen, rounds):
        """Capture one round of the static carry into a CUDA graph.  A
        warm-up round on copies of the carry (the generator's state saved
        and restored around it) loads every kernel and sizes the buffers
        first; the capture itself runs nothing."""
        from ..kernels import ops as kops
        dev = self.device
        g = {"gen": torch.Generator(device=dev),
             "carry": _clone_tree(self._ensure_carry(carry, 1)),
             "scen": _clone_tree(scen),
             "lrs": torch.zeros((rounds,), dtype=torch.float32, device=dev),
             "ctr": torch.zeros((1,), dtype=torch.int64, device=dev),
             "rounds": rounds}
        g["gen"].set_state(generator.get_state())
        state = g["gen"].get_state()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            lr0 = g["lrs"].index_select(0, g["ctr"]).squeeze(0)
            _, logs = self._body(_clone_tree(g["carry"]), lr0, g["gen"],
                                 scen=g["scen"])
            tel = self._tel_fn(logs) if self._tel_fn is not None else {}
        torch.cuda.current_stream(dev).wait_stream(side)
        g["gen"].set_state(state)
        g["tel"] = {k: torch.zeros((rounds,) + tuple(v.shape), dtype=v.dtype,
                                   device=dev) for k, v in tel.items()}

        def step():
            lr = g["lrs"].index_select(0, g["ctr"]).squeeze(0)
            new, logs = self._body(g["carry"], lr, g["gen"], scen=g["scen"])
            _copy_tree(g["carry"], new)
            if self._tel_fn is not None:
                for k, v in self._tel_fn(logs).items():
                    g["tel"][k].index_copy_(0, g["ctr"], v.reshape(1))
            g["ctr"].add_(1)
            return logs

        graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        try:
            graph.register_generator_state(g["gen"])
            with torch.cuda.graph(graph):
                g["logs"] = step()
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of the round failed ({type(exc).__name__}: "
                f"{exc}); run with graph=False for eager rounds") from exc
        after = kops.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after}
        g["graph"] = graph
        TRACE_COUNTS["capture"] += 1
        telemetry.event("capture", rounds=rounds, **{
            k: v for k, v in self.captured_launches.items() if v})
        self._g = g

    def _run_graph(self, carry, generator, lrs, scen, n_evals):
        R = int(lrs.shape[0])
        if self._g is None or self._g["rounds"] < R:
            self._capture(carry, generator, scen, max(R, self.cfg.rounds))
        g = self._g
        carry = self._ensure_carry(carry, 1)
        _copy_tree(g["carry"], carry)
        _copy_tree(g["scen"], scen)
        g["lrs"][:R].copy_(lrs)
        g["ctr"].zero_()
        g["gen"].set_state(generator.get_state())
        bufs = _Buffers(n_evals)
        for e, (start, n) in enumerate(self._segments(R)):
            for _ in range(n):
                with telemetry.profiled("fl.replay"):
                    g["graph"].replay()
                self.replays += 1
            self._evaluate(bufs, e, self.carry_params(g["carry"]),
                           g["logs"])
        generator.set_state(g["gen"].get_state())
        params = {k: v.clone()
                  for k, v in self.carry_params(g["carry"]).items()}
        tel = {k: v[:R].clone() for k, v in g["tel"].items()}
        return params, bufs.buf, tel


def _zip_map(fn, trees):
    """``fn(*leaves)`` across equally structured dict trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    return fn(*trees)


def _unstack(tree, n: int) -> list:
    """A tree of length-``n`` lists -> ``n`` trees."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return tree


def _draws_beyond_batches(cfg) -> Optional[str]:
    """What a round draws besides its minibatches, or None."""
    if cfg.n_selected < cfg.n_clients:
        return "the participating subset (participation < 1)"
    if cfg.attack.kind == "gaussian":
        return "gaussian attack noise"
    if cfg.fault.draws:
        return "fault rows"
    if cfg.aggregator == "resampling":
        return "the resampling rule's groups"
    return None
