"""Named draws from one ``--seed``.

Every input of a run (weights, data, the enclave's sample ids, the
Byzantine clients, the round generator) comes from its own generator,
seeded from ``--seed`` and the draw's name, so the program and the
reference get the same inputs and no draw shifts another.
"""
from __future__ import annotations

import hashlib

import torch


def seed_for(seed: int, name: str) -> int:
    """A 63-bit seed for the draw ``name`` of run ``seed`` (any int)."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, name))
