"""Micro-benchmarks (counterpart of the reference's committed
board_bench.md / gumbel_bench.md google-benchmark outputs).

Run on the GPU: python benchmarks/run_benchmarks.py
Writes benchmarks/results.md.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)

RESULTS = []
_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results.md")


def _flush():
    with open(_OUT, "w") as f:
        d = jax.devices()[0]
        f.write(f"# Benchmark results ({d.platform}, {d.device_kind})\n\n")
        f.write(f"date: {time.strftime('%Y-%m-%d %H:%M')}\n\n")
        f.write("| benchmark | value |\n|---|---|\n")
        for name, v in RESULTS:
            unit = "moves/s" if "throughput" in name else "ms"
            f.write(f"| {name} | {v:.2f} {unit} |\n")


def timeit_loop(name, body_fn, init, iters=50):
    """Time `iters` sequential applications inside one jitted device loop."""
    @jax.jit
    def run(x):
        return jax.lax.fori_loop(0, iters, lambda i, v: body_fn(v), x)

    r = run(init)
    jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
    t0 = time.time()
    r = run(init)
    jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
    ms = (time.time() - t0) / iters * 1000
    RESULTS.append((name, ms))
    _flush()
    print(f"{name}: {ms:.3f} ms")
    return ms


def timeit_call(name, fn, *args, reps=3):
    r = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
    t0 = time.time()
    for _ in range(reps):
        r = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(r)[0])
    ms = (time.time() - t0) / reps * 1000
    RESULTS.append((name, ms))
    _flush()
    print(f"{name}: {ms:.1f} ms")
    return ms


def main():
    from p3achygo_tpu.game.board import legal_mask_batch, new_state, step
    from p3achygo_tpu.mcts.gumbel import (
        SearchParams,
        make_eval_fn,
        search_root,
        uniform_eval_fn,
    )
    from p3achygo_tpu.models import build_model, get_config, init_params

    B = 1024
    states = jax.vmap(lambda _: new_state())(jnp.arange(B))

    timeit_loop(f"board step (B={B})",
                lambda st: step(st, jnp.full((B,), 60, jnp.int32))[0]
                if False else jax.vmap(step)(st, jnp.full((B,), 60, jnp.int32))[0],
                states)
    timeit_loop(f"legal_mask_batch (B={B})",
                lambda st: st._replace(
                    move_count=st.move_count
                    + legal_mask_batch(st)[:, 0].astype(jnp.int32)),
                states)

    for n, k in ((8, 4), (32, 4), (128, 8)):
        params = SearchParams(n=n, k=k, max_depth=24)
        f = jax.jit(lambda key, s, p=params: search_root(
            key, s, uniform_eval_fn, p))
        timeit_call(f"gumbel search n={n} k={k} dummy NN (B={B})",
                    f, jax.random.PRNGKey(0), states)

    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    efn = make_eval_fn(model, variables)
    params = SearchParams(n=32, k=4, max_depth=24)
    f = jax.jit(lambda key, s: search_root(key, s, efn, params))
    ms = timeit_call(f"gumbel search n=32 k=4 b12c128 (B={B})",
                     f, jax.random.PRNGKey(0), states)
    RESULTS.append((f"selfplay search throughput (b12c128 n=32)",
                    B / ms * 1000))
    _flush()

    planes = jnp.zeros((4096, 19, 19, 15))
    scal = jnp.zeros((4096, 8))
    timeit_loop("b12c128 fwd (W=4096)",
                lambda acc: acc + model.apply(
                    variables, planes, scal, train=False).pi_logits[:, 0],
                jnp.zeros((4096,)), iters=10)

    _flush()
    print("wrote", _OUT)


if __name__ == "__main__":
    main()
