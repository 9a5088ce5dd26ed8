"""Checkpoints as .npz files of flattened key paths (replaces
model_%04d.keras + live_model.keras files, rl_loop/fs_utils.py:25-65 /
gcs_utils.py:20-26 discovery semantics).

A checkpoint is a directory holding `arrays.npz`: one entry per leaf,
keyed by its pytree path (`jax.tree_util.keystr`). Dtypes numpy cannot
store natively (bfloat16, ...) are saved as raw bits and named in a
`__dtypes__` entry. Restoring walks a template pytree, so any tree works:
variables, optax state, the resume bundle.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

MODEL_FMT = "model_%04d"
LIVE_NAME = "live"
ARRAYS = "arrays.npz"
_DTYPES = "__dtypes__"


def save_named(root: str, name: str, tree: Any) -> str:
    """Save `tree` under root/name (overwrites atomically)."""
    path = os.path.join(os.path.abspath(root), name)
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    for key_path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(key_path)
        a = np.asarray(jax.device_get(leaf))
        if a.dtype.kind not in "biufc":  # bfloat16, float8: raw bits
            dtypes[key] = a.dtype.name
            a = a.view(f"u{a.dtype.itemsize}")
        arrays[key] = a
    arrays[_DTYPES] = np.asarray(json.dumps(dtypes))
    tmp = os.path.join(path, ARRAYS + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, ARRAYS))
    return path


def save_checkpoint(root: str, gen: int, tree: Any, live: bool = True) -> str:
    """Save `tree` as model_%04d (and update `live`)."""
    path = save_named(root, MODEL_FMT % gen, tree)
    if live:
        save_named(root, LIVE_NAME, tree)
    return path


def restore_checkpoint(path: str, template: Any) -> Any:
    """Load the checkpoint at `path` into the structure of `template`;
    every leaf must match the template's shape and dtype."""
    with np.load(os.path.join(path, ARRAYS)) as data:
        dtypes = json.loads(str(data[_DTYPES]))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
        out = []
        for key_path, ref in leaves:
            key = jax.tree_util.keystr(key_path)
            a = data[key]
            if key in dtypes:
                a = a.view(jnp.dtype(dtypes[key]))
            ref_dtype = np.asarray(ref).dtype
            if a.shape != np.shape(ref) or a.dtype != ref_dtype:
                raise ValueError(
                    f"{path}: {key} is {a.dtype}{list(a.shape)}, template "
                    f"wants {ref_dtype}{list(np.shape(ref))}")
            out.append(jnp.asarray(a) if isinstance(ref, jax.Array)
                       else a if isinstance(ref, np.ndarray)
                       else type(ref)(a.item()))
    return jax.tree_util.tree_unflatten(treedef, out)


def latest_generation(root: str) -> Optional[int]:
    """Most recent model_%04d in `root` (get_most_recent_model parity)."""
    if not os.path.isdir(root):
        return None
    gens = []
    for name in os.listdir(root):
        m = re.fullmatch(r"model_(\d{4})", name)
        if m:
            gens.append(int(m.group(1)))
    return max(gens) if gens else None
