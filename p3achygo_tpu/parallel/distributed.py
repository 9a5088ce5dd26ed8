"""Multi-host (multi-process) scale-out skeleton.

The reference scales by fanning self-play binaries across VMs that talk to
a GCS bus (SURVEY §2.13, python/rl_loop/*). This layout instead
uses jax.distributed + one global SPMD program:

- every host runs this same process and calls `init_multihost` (GRPC
  coordinator, jax.distributed.initialize);
- self-play envs are sharded over the global mesh's `data` axis — each
  host's chips own a contiguous slab of boards (`host_local_to_global`
  assembles the global array from per-host shards without gathering);
- golden weights are REPLICATED (`replicate`) — the broadcast is one
  device_put, and jit keeps them replicated across steps (the reference's
  model-download-from-GCS loop collapses into this);
- the train step is the same jit program as single-host: XLA inserts
  psum/all-gather collectives over ICI/DCN from the shardings alone.

In-flight game harvest stays host-local: each process reads back only its
own shards (`local_shards`), finalizes its games, and feeds its local
replay — the actor-learner "sample bus" is the data-parallel gradient
all-reduce, so no object store is needed for samples.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from p3achygo_tpu.parallel.mesh import make_mesh, param_partition_spec


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int,
                   local_device_count: Optional[int] = None) -> None:
    """Bootstrap this process into the jax.distributed cluster.

    Call BEFORE any other jax API touches the backend. On CPU smoke tests
    pass `local_device_count` to fan out virtual devices per host
    (XLA_FLAGS host platform device count).
    """
    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        flag = f"--xla_force_host_platform_device_count={local_device_count}"
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + flag).strip()
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over ALL processes' devices."""
    return make_mesh(len(jax.devices()), model_parallel=model_parallel)


def replicate(tree, mesh: Mesh):
    """Broadcast (replicate) a pytree to every device of the mesh — the
    golden-weight distribution step."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def shard_params_global(params, mesh: Mesh, model_parallel: int):
    """TP rule over the global mesh (replicated where not partitioned)."""
    def put(x):
        spec = param_partition_spec(x, model_parallel) \
            if hasattr(x, "ndim") else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, params)


def host_local_to_global(tree, mesh: Mesh):
    """Assemble global batch-sharded arrays from per-host local shards.

    Each process passes ITS slab (global_batch / num_processes rows); no
    host ever materializes the whole batch.
    """
    sh = NamedSharding(mesh, P("data"))

    def put(x):
        spec = P("data", *([None] * (x.ndim - 1)))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(x))

    del sh
    return jax.tree_util.tree_map(put, tree)


def local_shards(tree):
    """Read back THIS process's rows of a batch-sharded global pytree
    (host-local harvest: finalized games feed the local replay)."""
    def get(x):
        shards = [s for s in x.addressable_shards]
        shards.sort(key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    return jax.tree_util.tree_map(get, tree)
