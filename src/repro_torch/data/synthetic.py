"""Synthetic stand-ins for MNIST and CIFAR-10 (no dataset download): each
class is its own random template plus noise, so the task is learnable
(linear models reach high accuracy, like on MNIST) and label-flip and
backdoor attacks
behave as in the paper.  The construction is the reference's; the draws
come from a ``torch.Generator`` and land on that generator's device.
"""
from __future__ import annotations

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
