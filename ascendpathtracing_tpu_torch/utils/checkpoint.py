"""Checkpoint / resume for the differentiable pass: a copy of
``ascendpathtracing_tpu/utils/checkpoint.py`` (NumPy only), whose leaves
may also be torch tensors.

Scene/camera parameters and optimizer state (a pytree of arrays or
tensors) round-trip through a single ``.npz``.  The file format is the
JAX package's, so a checkpoint written by either package loads in the
other; leaves load back as NumPy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """Flatten a nested dict/list/tuple pytree of arrays to {path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}d:{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}:{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            if last:
                node[part] = leaf
            else:
                node = node.setdefault(part, {})
    return _rebuild(tree)


def _rebuild(node):
    if not isinstance(node, dict):
        return node
    kinds = {k.split(":", 1)[0] for k in node}
    if kinds == {"d"}:
        return {k.split(":", 1)[1]: _rebuild(v) for k, v in node.items()}
    if kinds <= {"l", "t"}:
        items = sorted(node.items(), key=lambda kv: int(kv[0].split(":", 1)[1]))
        seq = [_rebuild(v) for _, v in items]
        return seq if kinds == {"l"} else tuple(seq)
    raise ValueError(f"mixed pytree node kinds: {kinds}")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, params, *, step: int = 0, extra: dict | None = None):
    """Write params (pytree of arrays or tensors) + metadata to ``path``
    (.npz)."""
    flat = {k: _host(v) for k, v in _flatten(params).items()}
    meta = json.dumps({"step": step, "extra": extra or {}})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(meta.encode(), np.uint8), **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """-> (params pytree, step, extra dict)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return _unflatten(flat), meta["step"], meta["extra"]
