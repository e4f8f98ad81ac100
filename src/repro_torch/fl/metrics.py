"""Evaluation metrics as device scalars.

Every metric is a masked reduction over a static-shape set with exact
integer counts and one fp32 division at the end, so nothing here waits
on the card: the values leave the device only where the caller reads
them, at eval points.  The trigger-stamped backdoor test set is built
once per federation (:func:`make_backdoor_eval`, cached by
``Federation.backdoor_eval``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.attacks import AttackConfig
from .compression import get_codec, wire_bytes


def _ratio(num: torch.Tensor, den: torch.Tensor, empty: float) -> torch.Tensor:
    """Exact integer counts -> fp32 ratio; ``empty`` when ``den == 0``."""
    ratio = num.to(torch.float32) / den.clamp_min(1).to(torch.float32)
    return torch.where(den > 0, ratio, torch.full_like(ratio, empty))


def masked_accuracy(model, params, x: torch.Tensor, y: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of ``mask``-selected rows classified correctly (the whole
    set for ``mask=None``; 0 on an empty selection).  Device scalar."""
    hit = model.apply(params, x).argmax(-1) == y
    if mask is None:
        return hit.sum().to(torch.float32) / max(int(y.shape[0]), 1)
    keep = mask.to(torch.bool)
    return _ratio((hit & keep).sum(), keep.sum(), 0.0)


def accuracy(model, params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Whole-set accuracy (device scalar; 0 on an empty set)."""
    return masked_accuracy(model, params, x, y)


def mask_rates(mask: torch.Tensor, byz: torch.Tensor):
    """Byzantine-detection TPR/FPR from a round's keep-mask (True = kept;
    flagged means not kept).  TPR is 1.0 with no Byzantine client, FPR
    0.0 with no benign client.  Device scalars."""
    flagged = ~mask.to(torch.bool)
    byz = byz.to(torch.bool)
    tpr = _ratio((flagged & byz).sum(), byz.sum(), 1.0)
    fpr = _ratio((flagged & ~byz).sum(), (~byz).sum(), 0.0)
    return tpr, fpr


# ----------------------------------------------------------------------
# Backdoor eval set: stamped once, reused every eval
# ----------------------------------------------------------------------

def stamp_trigger(x: torch.Tensor) -> torch.Tensor:
    """The paper's pixel-pattern trigger on a batch: a 3x3 top-left patch
    of ones on images (every channel of NHWC ones), the first 3 features
    of flat inputs.  Returns a new tensor."""
    out = x.clone()
    if x.dim() >= 3:
        out[:, :3, :3] = 1.0
    else:
        out[:, :3] = 1.0
    return out


@dataclasses.dataclass(frozen=True)
class BackdoorEval:
    """The precomputed backdoor evaluation set for one federation: the
    whole test set with the trigger on every row (``x``) and the mask of
    rows whose true label is the attack's source class (``src``), the only
    rows the backdoor metric scores."""
    x: torch.Tensor
    src: torch.Tensor
    source_class: int
    target_class: int


def make_backdoor_eval(test_x: torch.Tensor, test_y: torch.Tensor,
                       acfg: AttackConfig) -> BackdoorEval:
    """Stamp the trigger once; every later eval is a masked reduction."""
    return BackdoorEval(x=stamp_trigger(test_x),
                        src=test_y == acfg.source_class,
                        source_class=acfg.source_class,
                        target_class=acfg.target_class)


def backdoor_accuracy_on(model, params, ev: BackdoorEval) -> torch.Tensor:
    """Fraction of trigger-stamped source-class inputs classified as the
    attacker's target class (lower = better defence); device scalar."""
    preds = model.apply(params, ev.x).argmax(-1)
    return _ratio(((preds == ev.target_class) & ev.src).sum(), ev.src.sum(),
                  0.0)


def backdoor_accuracy(model, params, test_x, test_y,
                      acfg: AttackConfig) -> torch.Tensor:
    """One-shot form (stamps inline).  Prefer ``Federation.backdoor_eval``
    + :func:`backdoor_accuracy_on` on any path that evaluates more than
    once."""
    return backdoor_accuracy_on(model, params,
                                make_backdoor_eval(test_x, test_y, acfg))


def main_task_accuracy(model, params, test_x, test_y,
                       acfg: AttackConfig) -> torch.Tensor:
    """Accuracy on all classes except the backdoor source class."""
    return masked_accuracy(model, params, test_x, test_y,
                           test_y != acfg.source_class)


def make_eval_fn(model, fed, cfg):
    """``eval_fn(params, logs) -> {metric: device tensor}``: accuracy on
    the federation's test set; main-task and backdoor accuracy under a
    backdoor attack; detection TPR/FPR whenever the rule emits a
    keep-mask; the per-client C1·C2 criterion when it logs one."""
    acfg = cfg.attack
    bd = fed.backdoor_eval(acfg) if acfg.kind == "backdoor" else None

    def eval_fn(params, logs):
        m = {"acc": accuracy(model, params, fed.test_x, fed.test_y)}
        if bd is not None:
            m["main_acc"] = masked_accuracy(model, params, fed.test_x,
                                            fed.test_y, ~bd.src)
            m["backdoor_acc"] = backdoor_accuracy_on(model, params, bd)
        if "mask" in logs:
            m["mask_tpr"], m["mask_fpr"] = mask_rates(logs["mask"],
                                                      logs["byz"])
        if "c1c2" in logs:
            m["c1c2"] = logs["c1c2"]
        return m
    return eval_fn


# ----------------------------------------------------------------------
# Communication cost
# ----------------------------------------------------------------------

def comm_stats(cfg, d: int):
    """Per-round wire traffic of one federated round, in bytes, as host
    ints and floats.  Uplink is what the ``cfg.n_selected`` participating
    clients send, each the codec's encoded size
    (``fl/compression.wire_bytes``: payload plus any scale sidecar);
    downlink is the server broadcasting the fp32 model to them (only the
    client→server direction is compressed)."""
    per_client = wire_bytes(get_codec(cfg.compression), d)
    c = cfg.n_selected
    dense = d * 4
    return {
        "uplink_bytes_per_client": int(per_client),
        "uplink_bytes_per_round": int(c * per_client),
        "downlink_bytes_per_round": int(c * dense),
        "dense_uplink_bytes_per_round": int(c * dense),
        "uplink_reduction": float(dense / per_client),
    }
