"""Carry model parameters between the JAX reference and the port.

Parameters cross as plain numpy arrays, so this module needs neither
framework's arrays on the other side: the caller converts the reference's
params with ``{k: np.asarray(v) for k, v in params.items()}`` (or, for
the zoo's nested trees, ``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def params_from_jax(params: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, same layout) -> float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Port params -> numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 -> fp32 -> bf16 is exact both ways
        return torch.from_numpy(a.astype(np.float32)).to(
            dev).to(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def tree_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """A nested tree of numpy arrays (dicts, tuples, lists; the zoo's
    params or caches) -> the same tree of tensors on ``device``, each
    keeping its dtype (bf16 included)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_from_jax(v, dev) for v in tree)
    return _leaf_from_numpy(tree, dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # only where a bf16 tensor crosses
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of :func:`tree_from_jax`: tensors -> numpy arrays on the
    host with their dtypes (bf16 as ``ml_dtypes.bfloat16``, JAX's)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)
