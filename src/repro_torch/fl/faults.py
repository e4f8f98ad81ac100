"""Device-malfunction models for async federated rounds, in PyTorch.

The paper's threat model has two axes: *adversarial* clients (the attack
registry in ``core/attacks.py``) and *faulty* clients, devices that
malfunction during training.  This module is the fault axis:

  * :class:`FaultConfig`: a frozen, hashable description of one
    malfunction model, carried on ``FLConfig.fault`` so that sweeps treat
    it as structure, like ``AttackConfig``;
  * :func:`make_cohort_chain`: the precomputed (R, N) per-round
    participation masks, drawn from a generator of their own (seeded
    apart from the training draws, see ``fl/engine.make_scenario``);
  * :func:`draw_faults` / :func:`corrupt_updates`: the per-round fault
    draw and the corruption at the client boundary, plain functions of
    device tensors (no host read).

Faults compose with attacks: a Byzantine client can also straggle, and
Eq. 6 tags its update when it lands.

Kinds:

``none``
    No faults; the async machinery is absent from the round.
``dropout``
    With per-client probability ``rate`` each round, the update never
    arrives: the client leaves the round's live set (weight 0 through the
    streaming fold's ``live`` channel).
``straggler``
    With probability ``rate``, the client finishes ``delay`` rounds late.
    Its update waits in the bounded staleness buffer of the round carry
    and folds through the same AggState monoid when it lands, with guides
    recomputed at the landing round.
``intermittent``
    With probability ``rate``, the update is corrupted in flight:
    ``mode="nan"`` / ``"inf"`` make the whole update non-finite (caught
    by the streaming fold's non-finite guard), ``"bitflip"`` scales it by
    ``bitflip_scale``, the float image of a flipped exponent bit (caught
    by Eq. 6's C2 band).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

FAULT_KINDS = ("none", "dropout", "straggler", "intermittent")
CORRUPTION_MODES = ("nan", "inf", "bitflip")


class DegenerateCohortError(ValueError):
    """A cohort chain selects zero clients in some round.

    Raised when an explicit chain is given.  A live set emptied at run
    time (cohort minus dropouts) is not an error: the weighted-mean
    fold's ``floor`` makes such a round a no-op (delta 0)."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One device-malfunction model: ``rate`` is the per-client, per-round
    malfunction probability, ``delay`` how many rounds late a straggler's
    update lands, ``mode``/``bitflip_scale`` the intermittent
    corruption."""
    kind: str = "none"
    rate: float = 0.0
    delay: int = 1
    mode: str = "nan"
    bitflip_scale: float = 2.0 ** 7

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; registered kinds: "
                f"{FAULT_KINDS}")
        if not (0.0 <= float(self.rate) <= 1.0):
            raise ValueError(
                f"fault rate must be in [0, 1], got {self.rate}")
        if isinstance(self.delay, bool) or not isinstance(self.delay, int) \
                or self.delay < 1:
            raise ValueError(
                f"fault delay must be a positive int, got {self.delay!r}")
        if self.mode not in CORRUPTION_MODES:
            raise ValueError(
                f"unknown corruption mode {self.mode!r}; registered "
                f"modes: {CORRUPTION_MODES}")

    @property
    def draws(self) -> bool:
        """Whether a round draws fault rows (kind set and rate > 0)."""
        return self.kind != "none" and self.rate > 0.0


def cohort_size(n_clients: int, participation: float) -> int:
    """Per-round cohort size: ceil like ``FLConfig.n_selected``, never
    zero."""
    return max(1, min(n_clients, math.ceil(participation * n_clients)))


def make_cohort_chain(n_clients: int, rounds: int, participation: float,
                      generator: torch.Generator) -> torch.Tensor:
    """The (R, N) bool cohort-mask chain: each round a fresh
    ``cohort_size`` subset drawn without replacement (the first c of a
    uniform random permutation of the clients), on ``generator``'s
    device."""
    c = cohort_size(n_clients, participation)
    keys = torch.rand((rounds, n_clients), generator=generator,
                      device=generator.device)
    sel = keys.argsort(dim=1, stable=True)[:, :c]
    chain = torch.zeros((rounds, n_clients), dtype=torch.bool,
                        device=generator.device)
    return chain.scatter_(1, sel, True)


def validate_cohort_chain(chain, n_clients: int, rounds: int) -> None:
    """Named-error check of an explicit cohort chain (reads it on the
    host, before a run)."""
    chain = torch.as_tensor(chain)
    if tuple(chain.shape) != (rounds, n_clients):
        raise DegenerateCohortError(
            f"cohort chain shape {tuple(chain.shape)} != (rounds, "
            f"n_clients) = ({rounds}, {n_clients})")
    per_round = chain.to(torch.int32).sum(1).cpu()
    if bool((per_round == 0).any()):
        bad = int((per_round == 0).to(torch.int32).argmax())
        raise DegenerateCohortError(
            f"cohort chain selects zero clients in round {bad}; every "
            "round needs at least one participant (dropout faults may "
            "still empty a round at run time, which is a no-op round)")


def draw_faults(n_clients: int, fcfg: FaultConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """Per-round i.i.d. fault draw: (N,) bool, True = malfunctions this
    round.  Draws nothing (all False) when ``fcfg`` has no faults."""
    if not fcfg.draws:
        return torch.zeros((n_clients,), dtype=torch.bool, device=device)
    u = torch.rand((n_clients,), generator=generator, device=device)
    return u < fcfg.rate


def corrupt_updates(U: torch.Tensor, fault_rows: torch.Tensor,
                    fcfg: FaultConfig) -> torch.Tensor:
    """Intermittent corruption at the client boundary: a (c, D) block of
    flat updates and its (c,) fault bits.  NaN/Inf bursts overwrite the
    whole row; bitflip scales it.  Rows without a fault pass through
    bitwise."""
    if fcfg.kind != "intermittent":
        return U
    rows = fault_rows.reshape(tuple(fault_rows.shape) + (1,) * (U.dim() - 1))
    if fcfg.mode == "nan":
        bad = torch.full_like(U, math.nan)
    elif fcfg.mode == "inf":
        bad = torch.full_like(U, math.inf)
    else:
        bad = U * fcfg.bitflip_scale
    return torch.where(rows, bad, U)


def init_async_state(cfg, flat_shape, device=None) -> Optional[dict]:
    """The async part of the round carry, or None when the config's async
    machinery is off.  ``r`` counts rounds (it indexes the cohort chain);
    with ``staleness_buffer`` B > 0 the O(B·D) pending slab: ``u`` the
    late updates, (B, *flat_shape), ``cid`` their client ids, ``ttl``
    rounds until landing, ``on`` slot occupancy.  ``flat_shape`` is one
    client's flat update, ``(D,)``; on a model axis ms > 1 it is the
    rank's row of the blocked layout, ``(L,)``, padding included
    (``RoundEngine.init_carry`` sizes it from the engine's own mesh), and
    only ``u`` differs between ranks."""
    if not cfg.async_rounds:
        return None
    state = {"r": torch.zeros((), dtype=torch.int64, device=device)}
    b = cfg.staleness_buffer
    if b > 0:
        state.update(
            u=torch.zeros((b,) + tuple(flat_shape), dtype=torch.float32,
                          device=device),
            cid=torch.zeros((b,), dtype=torch.int64, device=device),
            ttl=torch.zeros((b,), dtype=torch.int64, device=device),
            on=torch.zeros((b,), dtype=torch.bool, device=device))
    return state
