"""Device mesh + sharding rules (SURVEY.md §2.13).

The reference scales self-play by one-process-per-GPU over a filesystem bus
(train_sp_eval.py:345-365) and has only a dormant MirroredStrategy for
multi-GPU training. Here scaling is jax.sharding: a ('data', 'model') mesh,
batch sharded over 'data', large kernels optionally sharded over 'model'
(tensor parallelism for the b14c384/transformer nets), XLA inserting
all-reduces over ICI. One jitted train/selfplay step runs SPMD across the
mesh — no NCCL, no file relay.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1) -> Mesh:
    """('data', 'model') mesh over the first n_devices devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    grid = np.array(devices[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def param_partition_spec(leaf: jnp.ndarray, model_parallel: int) -> P:
    """TP rule: shard the output-channel dim of big kernels over 'model'.

    Kernels [.., in, out] with out divisible by the model axis and large
    enough to be worth sharding get P(..., 'model'); everything else is
    replicated. BatchNorm stats/scales stay replicated.
    """
    if model_parallel <= 1 or leaf.ndim < 2:
        return P()
    out = leaf.shape[-1]
    if out % model_parallel == 0 and out >= 8 * model_parallel:
        return P(*([None] * (leaf.ndim - 1)), MODEL_AXIS)
    return P()


def shard_params(params: Any, mesh: Mesh, model_parallel: int = 1) -> Any:
    """Place a param pytree on the mesh according to the TP rule."""
    def place(leaf):
        spec = param_partition_spec(leaf, model_parallel)
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(place, params)


def shard_batch(tree: Any, mesh: Mesh) -> Any:
    """Shard leading (batch) dim of every leaf over 'data'."""
    def place(leaf):
        spec = P(DATA_AXIS, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(place, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    def place(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, P()))
    return jax.tree_util.tree_map(place, tree)
