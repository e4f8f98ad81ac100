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
