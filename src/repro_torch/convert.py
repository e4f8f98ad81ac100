"""Carry model parameters between the JAX reference and the port.

Parameters cross as plain numpy arrays, so this module needs neither
framework's arrays on the other side: the caller converts the reference's
params with ``{k: np.asarray(v) for k, v in params.items()}`` (or, for
the zoo's nested trees, ``jax.tree.map(np.asarray, params)``).

The reference flattens a tree in JAX's leaf order: dict keys sorted at
every level, tuples and lists in order (:func:`leaf_paths`).  The port's
trees keep insertion order, so everything that lays a tree out flat (the
zoo's flat params, checkpoints) goes through :func:`leaf_paths`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

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


# ----------------------------------------------------------------------
# JAX's leaf order
# ----------------------------------------------------------------------

def leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs in JAX's leaf order: a dict's keys sorted,
    tuples and lists in order, at every level; a path holds the keys and
    indices as strings."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaf_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in leaf_paths(v, prefix + (str(i),))]
    return [(prefix, tree)]


def unflatten_like(like: Any, leaves: Sequence[Any]) -> Any:
    """The structure of ``like`` holding ``leaves``, given in JAX's leaf
    order (the inverse of :func:`leaf_paths`'s leaves)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more leaves than the structure "
                         "holds")
    return out


def flatten_tree(tree: Any) -> Dict[str, Any]:
    """A nested tree -> a flat ``{key: leaf}`` dict in JAX's leaf order
    (the leaves themselves, not copies).  A key is ``"<position>:<a/b/c>"``
    with the position zero-padded, so sorting the keys gives the leaf
    order, which sorting the paths alone would not (``"10" < "2"``, and
    ``-`` sorts before ``/``)."""
    pairs = leaf_paths(tree)
    w = max(3, len(str(len(pairs) - 1)))
    return {f"{i:0{w}d}:{'/'.join(path)}": leaf
            for i, (path, leaf) in enumerate(pairs)}


def zoo_params_from_jax(tree: Any, device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """A reference zoo params tree (numpy leaves, bf16 included) -> the
    port's flat zoo params (``fl/zoo.ZooModel``): tensors on ``device`` in
    JAX's leaf order, so the flat update D lines up with the reference's
    column for column."""
    return flatten_tree(tree_from_jax(tree, device))
