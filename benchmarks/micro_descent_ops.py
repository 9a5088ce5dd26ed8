"""Microbenchmark: descent-body primitive ops at fast-tier shapes.

Compares the per-level cost of the CURRENT while-body ops (per-lane
single-point gathers + multi-index path scatter) against one-hot einsum
equivalents, at B=768, L=20 (k=5 g=4), N=98, D=24.

Usage: python benchmarks/micro_descent_ops.py  (GPU, one process)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)

B, L, N, A, D, G = 768, 20, 98, 362, 24, 4
W = B * L


def timeit(name, fn, *args, iters=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.time() - t0) / iters * 1000
    print(f"{name}: {ms:.3f} ms", flush=True)
    return ms


def main():
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    children = jax.random.randint(k1, (B, N, A), -1, N, dtype=jnp.int32)
    act_table = jax.random.randint(k2, (B, N, G), 0, A, dtype=jnp.int32)
    child_table = jax.random.randint(k2, (B, N, G), -1, N, dtype=jnp.int32)
    node = jax.random.randint(k3, (W,), 0, N, dtype=jnp.int32)
    a = jax.random.randint(k4, (W,), 0, A, dtype=jnp.int32)
    depth = jax.random.randint(k5, (W,), 0, D, dtype=jnp.int32)
    paths = jnp.full((W, D), -1, jnp.int32)
    bw = jnp.arange(W) // L
    lane = jnp.arange(W)

    # 10 repeats inside jit to amortize host->device dispatch.
    def rep(f):
        def run(*args):
            out = f(*args)
            for _ in range(9):
                out = f(*args) + out
            return out
        return jax.jit(run)

    # 1) current: per-lane gather from act_table
    timeit("gather act_table[bw,node,0]",
           rep(lambda n_: act_table[bw, n_, 0]), node)
    # 2) current: per-lane 2-index gather from children
    timeit("gather children[bw,node,a]",
           rep(lambda n_, a_: children[bw, n_, a_]), node, a)
    # 3) current: path scatter at [lane, depth]
    timeit("scatter paths[lane,depth]",
           rep(lambda d_, n_: paths.at[lane, d_].set(n_)), depth, node)
    # 4) one-hot read from a [B,N,G] table
    def oh_read(n_):
        ohn = jax.nn.one_hot(n_.reshape(B, L), N, dtype=jnp.float32)
        out = jnp.einsum("bln,bng->blg", ohn,
                         child_table.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
        return out.reshape(W, G).astype(jnp.int32)
    timeit("one-hot read [B,N,G] table", rep(oh_read), node)
    # 5) one-hot path write (select by depth one-hot)
    def oh_write(d_, n_):
        ohd = jax.nn.one_hot(d_, D, dtype=jnp.bool_)
        return jnp.where(ohd, n_[:, None], paths)
    timeit("one-hot path write", rep(oh_write), depth, node)
    # 6) combined one-hot body: table read + path write + elementwise
    def body_like(n_, d_):
        ohn = jax.nn.one_hot(n_.reshape(B, L), N, dtype=jnp.float32)
        out = jnp.einsum("bln,bng->blg", ohn,
                         child_table.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
        child = out.reshape(W, G)[:, 0].astype(jnp.int32)
        ohd = jax.nn.one_hot(d_, D, dtype=jnp.bool_)
        newp = jnp.where(ohd, child[:, None], paths)
        return newp[:, 0] + child
    timeit("one-hot body (read+write)", rep(body_like), node, depth)


if __name__ == "__main__":
    main()
