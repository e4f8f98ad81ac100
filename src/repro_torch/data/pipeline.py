"""Federated data pipeline: per-client datasets cut to a common size so
the whole federation stacks into (N, n, ...) tensors and every client's
local training runs as one batched pass; plus the once-before-training
enclave sample draw (Step 1).

Every random draw takes a ``torch.Generator`` *or* explicit index
arrays, so a test can feed the port the exact draws the reference made.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch


def _draw_device(generator: Optional[torch.Generator],
                 default: torch.device) -> torch.device:
    """Draws happen on the generator's device (torch requires it)."""
    return generator.device if generator is not None else default


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

    def minibatch(self, batch_size: int,
                  generator: Optional[torch.Generator] = None,
                  idx: Optional[torch.Tensor] = None):
        """One mini-batch per client, drawn with replacement: (N, m, ...),
        (N, m).  ``idx`` (N, m) gives the draw explicitly."""
        if idx is None:
            idx = torch.randint(0, self.per_client,
                                (self.n_clients, batch_size),
                                generator=generator,
                                device=_draw_device(generator, self.device))
        elif tuple(idx.shape) != (self.n_clients, batch_size):
            raise ValueError(f"minibatch idx must be ({self.n_clients}, "
                             f"{batch_size}), got {tuple(idx.shape)}")
        return self._gather(idx)

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
