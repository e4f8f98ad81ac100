"""Minimal, dependency-free param-tree checkpointing (npz + structure
file), the counterpart of ``repro/checkpoint/store.py``.

Layout: ``<dir>/step_<n:08d>.npz`` with the leaves keyed ``leaf_<i>`` in
JAX's leaf order (``convert.leaf_paths``), the reference's layout; a bf16
leaf is stored as its raw 2-byte pattern, the bytes the reference's npz
holds for one.  The structure sidecar is the port's own,
``step_<n>.npz.structure.json`` (the tree's dicts, tuples and lists and
each leaf's dtype): the reference's is a pickled JAX treedef, which the
port cannot read without JAX.  So :func:`restore_checkpoint` also takes
the structure from a ``like=`` tree, which reads a reference checkpoint.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ..convert import leaf_paths, unflatten_like
from ..device import DeviceLike, resolve_device


def _dtype_name(leaf) -> str:
    """A leaf's dtype as a name both numpy's and torch's sides read."""
    return str(leaf.dtype).replace("torch.", "")


def _structure(tree) -> Any:
    """The tree's containers, each leaf replaced by its dtype name."""
    if isinstance(tree, dict):
        return {"dict": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {type(tree).__name__: [_structure(v) for v in tree]}
    return {"leaf": _dtype_name(tree)}


def _from_structure(s) -> Any:
    (kind, body), = s.items()
    if kind == "dict":
        return {k: _from_structure(v) for k, v in body.items()}
    if kind in ("tuple", "list"):
        return (tuple if kind == "tuple" else list)(
            _from_structure(v) for v in body)
    return body


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(a: np.ndarray, dtype: str, dev: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype.kind != "V":          # a bf16-typed array (ml_dtypes)
            a = a.view("V2")
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (tensors or numpy arrays in dicts, tuples and
    lists) as step ``step``; -> the npz's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    leaves = [leaf for _, leaf in leaf_paths(tree)]
    np.savez(path, **{f"leaf_{i}": _to_numpy(leaf)
                      for i, leaf in enumerate(leaves)})
    with open(path + ".structure.json", "w") as f:
        json.dump(_structure(tree), f)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step saved in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, *,
                       like=None, device: DeviceLike = None):
    """-> ``(tree, step)``: step ``step`` (default: the latest) as tensors
    on ``device`` (the card unless given).  The structure and dtypes come
    from ``like`` (a tree of tensors or arrays) when given, else from the
    port's structure sidecar."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _path(ckpt_dir, step)
    if like is not None:
        skeleton = unflatten_like(like, [_dtype_name(leaf) for _, leaf
                                         in leaf_paths(like)])
    elif os.path.exists(path + ".structure.json"):
        with open(path + ".structure.json") as f:
            skeleton = _from_structure(json.load(f))
    else:
        raise FileNotFoundError(
            f"{path} has no port structure sidecar (a reference checkpoint "
            f"carries a pickled JAX treedef, which the port cannot read): "
            f"pass like= a tree of the same structure")
    dtypes = [d for _, d in leaf_paths(skeleton)]
    dev = resolve_device(device)
    with np.load(path) as data:
        if len(data.files) != len(dtypes):
            raise ValueError(f"{path} holds {len(data.files)} leaves, the "
                             f"structure {len(dtypes)}")
        leaves = [_to_tensor(data[f"leaf_{i}"], d, dev)
                  for i, d in enumerate(dtypes)]
    return unflatten_like(skeleton, leaves), step
