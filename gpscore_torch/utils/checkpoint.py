"""Checkpoints of parameter trees, fit results and metric tables (port of
`gpscore/utils/checkpoint.py`).

A tree of tensors (a :class:`~gpscore_torch.utils.params.GPParams`, a batch
of them, a ``FitResult`` with its ``param_history``, tuples, lists and dicts
of these) round-trips through one ``.npz`` file in the JAX package's layout,
so either package reads the other's files: ``leaf_i`` for the i-th leaf in
``jax.tree_util``'s order, and ``__meta__``, the JSON leaf count as uint8
bytes. That order is: a dataclass (GPParams) and a NamedTuple by field, a
tuple or list in order, a dict by sorted key; ``None`` is a node with no
leaf; anything else (a tensor, an array, a number) is a leaf. Metric tables
save as plain JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch


def _children(node):
    """(children, rebuild) of a tree node, or None for a leaf."""
    if node is None:
        return [], lambda _: None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return ([getattr(node, f) for f in names],
                lambda kids: dataclasses.replace(node, **dict(zip(names, kids))))
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return list(node), lambda kids: type(node)(*kids)
    if isinstance(node, (tuple, list)):
        return list(node), type(node)
    if isinstance(node, dict):
        keys = sorted(node)
        return [node[k] for k in keys], lambda kids: dict(zip(keys, kids))
    return None


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util``'s order."""
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for kid in node[0] for leaf in tree_leaves(kid)]


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` in its leaves' places."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return kids[1]([build(k) for k in kids[0]])

    return build(template)


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Save any tree of tensors, arrays or numbers to ``path`` (.npz), each
    leaf with its own dtype and shape, from any device. The file appears
    whole or not at all."""
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps({"num_leaves": len(leaves)}).encode(), dtype=np.uint8
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_leaves(path: str) -> List[np.ndarray]:
    """The leaves of a file written by :func:`save_pytree` (or the JAX
    package's), as numpy arrays in order."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        return [z[f"leaf_{i}"] for i in range(meta["num_leaves"])]


def load_pytree(path: str, template: Any) -> Any:
    """Load a tree saved by :func:`save_pytree`. ``template`` gives the
    structure (its leaf values are not read); the leaves come back as
    tensors of the saved dtype and shape, on the device of the template's
    first tensor leaf (the CPU where it has none)."""
    leaves = load_leaves(path)
    want = tree_leaves(template)
    if len(want) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves; template expects {len(want)}")
    device = next((t.device for t in want if isinstance(t, torch.Tensor)), torch.device("cpu"))
    return tree_unflatten(template, [torch.from_numpy(a).to(device) for a in leaves])


def _plain(v):
    """``v`` with every tensor or array as a number or nested list."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


def save_metrics(path: str, metrics: Dict[str, Any]) -> None:
    """Metric tables (nested dicts of numbers, lists, tensors on any device
    or arrays) as JSON."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_plain(metrics), f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_metrics(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
