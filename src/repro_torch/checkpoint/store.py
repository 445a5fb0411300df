"""Checkpointing: trees of arrays -> one ``.npz`` plus a JSON manifest.

The port of the reference's ``repro.checkpoint.store``, without JAX.
Layout: ``<dir>/step_<n:08d>/arrays.npz + manifest.json``. A tree is
nested dicts, lists and tuples; its leaves (numpy arrays, tensors,
scalars) are written as numpy arrays, named by their path as
``jax.tree_util.tree_flatten_with_path`` names them: dict keys (in sorted
order) and sequence indices joined by ``/``. The manifest holds the
names, shapes and dtypes, and a ``treedef`` string of this package's own.
Restores return numpy arrays; the caller moves them to its device.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in ``jax.tree_util`` order. ``None`` is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _treedef(tree) -> str:
    """The tree's structure as a string: ``{k: ..}``, ``[..]``, ``(..)``,
    ``*`` a leaf and ``None`` an empty subtree."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "None" if tree is None else "*"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _step_dir(directory: str, step: Optional[int]) -> str:
    return directory if step is None else os.path.join(directory,
                                                       f"step_{step:08d}")


def save_pytree(tree, directory: str, step: Optional[int] = None) -> str:
    d = _step_dir(directory, step)
    os.makedirs(d, exist_ok=True)
    arrays = {name: _numpy(leaf) for name, leaf in _items(tree)}
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    manifest = {
        "treedef": _treedef(tree),
        "names": sorted(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return d


def _rebuild(like, arrays, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], arrays, f"{prefix}{k}/") for k in like}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(x, arrays, f"{prefix}{i}/") for i, x in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    return None if like is None else arrays[prefix[:-1]]


def load_pytree(directory: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like`` (its leaf names must be in
    the checkpoint; its leaf values are ignored)."""
    with np.load(os.path.join(_step_dir(directory, step),
                              "arrays.npz")) as data:
        arrays = {name: data[name] for name, _ in _items(like)}
    return _rebuild(like, arrays)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", f))]
    return max(steps) if steps else None


def save_train_state(params, opt_state, step: int, directory: str) -> str:
    return save_pytree({"params": params, "opt": opt_state,
                        "step": np.int64(step)}, directory, step)


def load_train_state(directory: str, like_params, like_opt,
                     step: Optional[int] = None):
    step = step if step is not None else latest_step(directory)
    tree = load_pytree(directory, {"params": like_params, "opt": like_opt,
                                   "step": np.int64(0)}, step)
    return tree["params"], tree["opt"], int(tree["step"])
