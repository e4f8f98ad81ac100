"""Evaluation metrics as device scalars.

Every metric is a masked reduction over a static-shape set with exact
integer counts and one fp32 division at the end, so nothing here waits
on the card: the values leave the device only where the caller reads
them, at eval points.
"""
from __future__ import annotations

import torch


def _ratio(num: torch.Tensor, den: torch.Tensor, empty: float) -> torch.Tensor:
    """Exact integer counts -> fp32 ratio; ``empty`` when ``den == 0``."""
    ratio = num.to(torch.float32) / den.clamp_min(1).to(torch.float32)
    return torch.where(den > 0, ratio, torch.full_like(ratio, empty))


def accuracy(model, params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Whole-set accuracy (device scalar; 0 on an empty set)."""
    hits = (model.apply(params, x).argmax(-1) == y).sum()
    return hits.to(torch.float32) / max(int(y.shape[0]), 1)


def mask_rates(mask: torch.Tensor, byz: torch.Tensor):
    """Byzantine-detection TPR/FPR from a round's keep-mask (True = kept;
    flagged means not kept).  TPR is 1.0 with no Byzantine client, FPR
    0.0 with no benign client.  Device scalars."""
    flagged = ~mask.to(torch.bool)
    byz = byz.to(torch.bool)
    tpr = _ratio((flagged & byz).sum(), byz.sum(), 1.0)
    fpr = _ratio((flagged & ~byz).sum(), (~byz).sum(), 0.0)
    return tpr, fpr


def make_eval_fn(model, fed, cfg):
    """``eval_fn(params, logs) -> {metric: device tensor}``: accuracy on
    the federation's test set, detection TPR/FPR whenever the rule emits
    a keep-mask, and the per-client C1·C2 criterion when it logs one."""
    def eval_fn(params, logs):
        m = {"acc": accuracy(model, params, fed.test_x, fed.test_y)}
        if "mask" in logs:
            m["mask_tpr"], m["mask_fpr"] = mask_rates(logs["mask"],
                                                      logs["byz"])
        if "c1c2" in logs:
            m["c1c2"] = logs["c1c2"]
        return m
    return eval_fn
