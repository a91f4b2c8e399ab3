"""Checkpointing: flat-key ``.npz`` save and restore of parameter and
optimizer trees.

The port of ``repro/checkpoint/io.py``, in the same format. Keys are the
'/'-joined paths of the tree's leaves (dict keys, list indices and the
field names of a NamedTuple such as ``AdamWState``); ``restore`` rebuilds
into a given target tree, each leaf in the target's dtype and on its
device. Writes are atomic (a temporary file in the directory, then
``os.replace``), so an interrupted save never corrupts the latest
checkpoint; files are ``step_%08d.npz`` and the newest ``keep`` stay.

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit patterns
(``uint16``) and its key is listed in the entry ``BF16_KEYS``, so it
round-trips bit for bit.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: The entry listing the keys stored as bfloat16 bit patterns.
BF16_KEYS = "__bfloat16_bits__"


def _flatten(tree) -> list:
    """(key, leaf) of every leaf, in the tree's order."""
    return [("/".join(_seg(p) for p in path), leaf)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]]


def _seg(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return str(p.idx)
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    flat, bf16 = {}, []
    for key, leaf in _flatten(tree):
        flat[key] = _to_numpy(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16.append(key)
    flat[BF16_KEYS] = np.array(bf16, dtype=np.str_)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    _gc(directory, keep)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``target``: every leaf in the
    target's dtype and on its device. Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    out = []
    with np.load(path) as data:
        bf16 = set(data[BF16_KEYS].tolist()) if BF16_KEYS in data else set()
        for key, leaf in _flatten(target):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            val = data[key]
            if hasattr(leaf, "shape") and tuple(leaf.shape) != val.shape:
                raise ValueError(f"{key}: shape {val.shape} != "
                                 f"{tuple(leaf.shape)}")
            if key in bf16:
                t = torch.from_numpy(val.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(val)
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            out.append(t)
    return pytree.tree_unflatten(out, pytree.tree_structure(target))


def _gc(directory: str, keep: int) -> None:
    files = sorted(f for f in os.listdir(directory)
                   if re.match(r"step_\d+\.npz$", f))
    for f in files[:-keep]:
        os.remove(os.path.join(directory, f))
