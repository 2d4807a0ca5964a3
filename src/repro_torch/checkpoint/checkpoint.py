"""Checkpoints of trees of tensors on npz, in the reference's layout.

A copy of ``repro/checkpoint/checkpoint.py`` for trees of dicts, lists and
tuples of tensors, so that each package loads the other's files:
``ckpt_%08d.npz`` (written to a temporary file and moved into place with
``os.replace``) beside an optional ``ckpt_%08d.json`` of extra state; each
leaf under its ``/``-joined key path (a dict key as it is, a list or
tuple index as its number); bfloat16 stored as its uint16 bits under the
``__bf16__`` prefix (npz has no bfloat16) and read back through
``view(torch.bfloat16)``. Loading restores into the structure of a
reference tree, checks every shape and casts to the reference's dtype.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path

BF16_TAG = "__bf16__"


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict:
    flat = {}
    for path, leaf in leaves_with_path(tree):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz can't store bfloat16
            flat[BF16_TAG + _key(path)] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            flat[_key(path)] = t.numpy()
    return flat


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    if extra is not None:
        with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
            json.dump(extra, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def load_checkpoint(directory: str, reference_tree: Any,
                    step: Optional[int] = None):
    """Restore into the structure of ``reference_tree`` (a tree of
    tensors, which may lie on the meta device); returns (tree, extra).
    Each leaf takes its reference's dtype and device (the CPU for a meta
    reference); a shape that differs raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    leaves = []
    with np.load(path) as data:
        for kpath, ref in leaves_with_path(reference_tree):
            key = _key(kpath)
            if key in data:
                t = torch.from_numpy(data[key])
            else:
                t = torch.from_numpy(
                    data[BF16_TAG + key].view(np.int16)).view(torch.bfloat16)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(ref.shape)}")
            device = "cpu" if ref.device.type == "meta" else ref.device
            leaves.append(t.to(device=device, dtype=ref.dtype))
    extra_path = os.path.join(directory, f"ckpt_{step:08d}.json")
    extra = None
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    it = iter(leaves)
    return map_with_path(lambda _, ref: next(it), reference_tree), extra
