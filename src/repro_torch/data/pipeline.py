"""Federated data pipeline: per-client datasets cut to a common size so
the whole federation stacks into (N, n, ...) tensors and every client's
local training runs as one batched pass; plus the once-before-training
enclave sample draw (Step 1).

Every random draw takes a ``torch.Generator`` *or* explicit index
arrays, so a test can feed the port the exact draws the reference made.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch


def _draw_device(generator: Optional[torch.Generator],
                 default: torch.device) -> torch.device:
    """Draws happen on the generator's device (torch requires it)."""
    return generator.device if generator is not None else default


@dataclasses.dataclass
class ClientDataset:
    x: torch.Tensor
    y: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.y.shape[0])


@dataclasses.dataclass
class FederatedData:
    """Stacked federation: x (N, n, ...), y (N, n); n = min client size."""
    x: torch.Tensor
    y: torch.Tensor
    n_classes: int

    @property
    def n_clients(self) -> int:
        return int(self.y.shape[0])

    @property
    def per_client(self) -> int:
        return int(self.y.shape[1])

    @property
    def device(self) -> torch.device:
        return self.x.device

    @classmethod
    def from_partitions(cls, parts: List[Tuple[torch.Tensor, torch.Tensor]],
                        n_classes: int) -> "FederatedData":
        n = min(int(p[1].shape[0]) for p in parts)
        return cls(x=torch.stack([p[0][:n] for p in parts]),
                   y=torch.stack([p[1][:n] for p in parts]),
                   n_classes=n_classes)

    def to(self, device) -> "FederatedData":
        return FederatedData(self.x.to(device), self.y.to(device),
                             self.n_classes)

    def _gather(self, idx: torch.Tensor):
        rows = torch.arange(self.n_clients, device=self.device)[:, None]
        idx = idx.to(self.device)
        return self.x[rows, idx], self.y[rows, idx]

    def minibatch_idx(self, batch_size: int,
                      generator: Optional[torch.Generator] = None,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (N, m) row indices of one mini-batch per client, drawn with
        replacement (or ``idx``, checked)."""
        if idx is None:
            return torch.randint(0, self.per_client,
                                 (self.n_clients, batch_size),
                                 generator=generator,
                                 device=_draw_device(generator, self.device))
        if tuple(idx.shape) != (self.n_clients, batch_size):
            raise ValueError(f"minibatch idx must be ({self.n_clients}, "
                             f"{batch_size}), got {tuple(idx.shape)}")
        return idx

    def minibatch(self, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None):
        """One mini-batch per client, drawn with replacement: (N, m, ...),
        (N, m).  ``idx`` (N, m) gives the draw explicitly."""
        return self._gather(self.minibatch_idx(batch_size, generator, idx))

    def client_minibatch(self, idx: torch.Tensor, clients: torch.Tensor):
        """The mini-batches of the ``clients`` ids only, from the whole
        (N, m) draw ``idx``: rows ``clients`` of :meth:`minibatch`'s
        stacks, bit for bit, without building the others."""
        clients = clients.to(self.device)
        idx = idx.to(self.device)[clients]
        return self.x[clients[:, None], idx], self.y[clients[:, None], idx]

    def segment_minibatches(self, rounds: int, batch_size: int,
                            generator: Optional[torch.Generator] = None,
                            idx: Optional[torch.Tensor] = None,
                            rows: Optional[Tuple[int, int]] = None):
        """Minibatch stacks for one segment of ``rounds`` rounds of the
        round engine: (T, N, m, ...), (T, N, m).  Row t is drawn exactly as
        the t-th of ``rounds`` successive :meth:`minibatch` calls on
        ``generator`` would draw it, so a segment's stack equals the inline
        draws bitwise.  ``idx`` (T, N, m) gives the draws explicitly.

        ``rows`` ``(lo, hi)`` builds only those client rows, (T, hi - lo,
        m, ...), as a data rank of a split round holds them
        (``sharding.client_split``): the whole (T, N, m) index tensor is
        still drawn, so the generator stays in step with the one-process
        run, and the stacks are the whole stacks' rows bit for bit."""
        if idx is None:
            idx = torch.stack([
                torch.randint(0, self.per_client,
                              (self.n_clients, batch_size),
                              generator=generator,
                              device=_draw_device(generator, self.device))
                for _ in range(rounds)])
        elif tuple(idx.shape) != (rounds, self.n_clients, batch_size):
            raise ValueError(f"segment idx must be ({rounds}, "
                             f"{self.n_clients}, {batch_size}), got "
                             f"{tuple(idx.shape)}")
        lo, hi = (0, self.n_clients) if rows is None else rows
        ids = torch.arange(lo, hi, device=self.device)[None, :, None]
        idx = idx.to(self.device)[:, lo:hi]
        return self.x[ids, idx], self.y[ids, idx]

    def sample_size(self, frac: float) -> int:
        """The enclave sample size s = frac * n_j (at least 1)."""
        return max(1, int(self.per_client * frac))

    def enclave_samples(self, frac: float,
                        generator: Optional[torch.Generator] = None,
                        idx: Optional[torch.Tensor] = None):
        """Step 1: a uniform sample M_j⁰ of s = frac * n_j rows per client,
        without replacement.  ``idx`` (N, s) gives the draw explicitly."""
        s = self.sample_size(frac)
        if idx is None:
            keys = torch.rand((self.n_clients, self.per_client),
                              generator=generator,
                              device=_draw_device(generator, self.device))
            idx = keys.argsort(dim=1)[:, :s]
        elif tuple(idx.shape) != (self.n_clients, s):
            raise ValueError(f"enclave sample idx must be ({self.n_clients}, "
                             f"{s}), got {tuple(idx.shape)}")
        return self._gather(idx)


def batch_iterator(generator: Optional[torch.Generator], x: torch.Tensor,
                   y: torch.Tensor, batch_size: int,
                   idx: Optional[torch.Tensor] = None
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Minibatches of ``batch_size`` rows drawn with replacement: endless
    draws from ``generator``, or one batch per row of ``idx`` (steps,
    batch_size) and then stop."""
    if idx is None:
        return _draw_batches(generator, x, y, batch_size)
    if idx.dim() != 2 or idx.shape[1] != batch_size:
        raise ValueError(f"batch idx must be (steps, {batch_size}), got "
                         f"{tuple(idx.shape)}")
    return ((x[rows], y[rows]) for rows in idx.to(y.device))


def _draw_batches(generator, x, y, batch_size):
    n = int(y.shape[0])
    while True:
        rows = torch.randint(0, n, (batch_size,), generator=generator,
                             device=_draw_device(generator, y.device))
        rows = rows.to(y.device)
        yield x[rows], y[rows]
