"""Learning-rate schedules of the paper's experiments.

A schedule maps the 1-based round index to a Python float computed in
float32, as the reference computes it, so the rate enters each round as
a host scalar and reading it never waits on the card.
"""
from __future__ import annotations

import numpy as np


def constant_lr(lr0):
    return lambda i: float(np.float32(lr0))


def inv_sqrt_lr(lr0):
    """mu^(i) = lr0 / sqrt(i)  (softmax-regression experiments, after [23])."""
    return lambda i: float(np.float32(lr0)
                           / np.sqrt(np.float32(max(int(i), 1))))


def _decay(i, boundaries, factor) -> np.float32:
    """factor ** (boundaries passed by round i), in float32."""
    k = int((np.float32(i) >= np.asarray(boundaries)).sum())
    return np.float32(factor) ** np.float32(k)


def step_decay_lr(lr0, boundaries, factor):
    """Step decay: multiply by `factor` at each boundary round."""
    return lambda i: float(np.float32(lr0) * _decay(i, boundaries, factor))


def warmup_then_step_lr(lr_start, lr_peak, warmup_rounds, boundaries, factor):
    """CIFAR recipe: linear warmup lr_start->lr_peak, then step decay."""
    def f(i):
        frac = min(np.float32(i) / np.float32(max(warmup_rounds, 1)),
                   np.float32(1.0))
        warm = np.float32(lr_start) + np.float32(lr_peak - lr_start) * frac
        return float(warm * _decay(i, boundaries, factor))
    return f
