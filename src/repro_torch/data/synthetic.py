"""Synthetic stand-ins for MNIST and CIFAR-10 (no dataset download): each
class is its own random template plus noise, so the task is learnable
(linear models reach high accuracy, like on MNIST) and label-flip and
backdoor attacks behave as in the paper; and Zipf-ish token streams for
the zoo's language models.  The constructions are the reference's; the
draws come from a ``torch.Generator`` and land on that generator's
device.
"""
from __future__ import annotations

from typing import Optional

import torch


def make_classification(generator: torch.Generator, n: int, n_classes: int,
                        dim: int, noise: float = 0.35,
                        template_scale: float = 1.0,
                        template_seed: int = 1234):
    """Gaussian class-template data: x = T[y] + noise * N(0, I).

    Templates come from a *fixed* seed, so different calls (train and test
    splits) share the same class structure."""
    dev = generator.device
    tgen = torch.Generator(device=dev).manual_seed(template_seed + dim)
    templates = torch.randn((n_classes, dim), generator=tgen,
                            device=dev) * template_scale
    y = torch.randint(0, n_classes, (n,), generator=generator, device=dev)
    x = templates[y] + noise * torch.randn((n, dim), generator=generator,
                                           device=dev)
    return x.to(torch.float32), y


def make_mnist_like(generator: torch.Generator, n: int = 6900,
                    n_classes: int = 10):
    x, y = make_classification(generator, n, n_classes, 28 * 28, noise=0.5)
    return x.reshape(n, 28, 28), y


def make_cifar_like(generator: torch.Generator, n: int = 6900,
                    n_classes: int = 10):
    """CIFAR-shaped images in the reference's NHWC layout, (n, 32, 32, 3)."""
    x, y = make_classification(generator, n, n_classes, 32 * 32 * 3,
                               noise=0.6)
    return x.reshape(n, 32, 32, 3), y


def make_token_stream(generator: Optional[torch.Generator], n_seqs: int,
                      seq_len: int, vocab: int, zipf_a: float = 1.2, *,
                      u: Optional[torch.Tensor] = None,
                      shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zipf-ish synthetic token data for the LLM architectures: a mixture
    of per-sequence topic distributions so there is learnable structure.
    -> (n_seqs, seq_len) int64 ids in [0, vocab).

    The two draws, ``u`` (n_seqs, seq_len) uniform in [1e-6, 1) and
    ``shift`` (n_seqs, 1) ids, come from ``generator`` (``u`` first) or
    are given explicitly, so a caller can inject the reference's."""
    dev = u.device if u is not None else generator.device
    if u is None:
        u = torch.rand((n_seqs, seq_len), generator=generator, device=dev)
        u = u * (1.0 - 1e-6) + 1e-6
    if shift is None:
        shift = torch.randint(0, vocab, (n_seqs, 1), generator=generator,
                              device=dev)
    if tuple(u.shape) != (n_seqs, seq_len) or \
            tuple(shift.shape) != (n_seqs, 1):
        raise ValueError(f"make_token_stream: u must be ({n_seqs}, "
                         f"{seq_len}) and shift ({n_seqs}, 1), got "
                         f"{tuple(u.shape)} and {tuple(shift.shape)}")
    # the exponent as the reference's fp32 scalar -zipf_a + 1e-9
    inv = torch.tensor(-zipf_a + 1e-9, dtype=torch.float32, device=dev)
    ranks = torch.floor(torch.exp(torch.log(u.to(torch.float32)) / inv)) \
        % vocab
    return (ranks.to(torch.int64) + shift.to(dev, torch.int64)) % vocab
