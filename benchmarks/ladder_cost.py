"""Cost of always-on ladder feature planes at production search widths.

VERDICT r2 missing #3: the reference fills planes 13-14 unconditionally
(go_features.cc:38-62); the repo gates them off citing cost with no
measurement. Measure laddered_stones + full featurize at the real sweep
widths so the gate carries a number (or gets flipped).

Usage: python benchmarks/ladder_cost.py  (GPU, one process)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def timeit(name, fn, *args, iters=6):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.time() - t0) / iters * 1000
    print(f"  {name}: {ms:.2f} ms", flush=True)
    return ms


def main():
    from p3achygo_tpu.features import batched_features
    from p3achygo_tpu.game.board import legal_mask, new_state, step
    from p3achygo_tpu.game.ladder import laddered_stones

    B0 = 1024
    states = jax.vmap(lambda _: new_state(7.5))(jnp.arange(B0))
    key = jax.random.PRNGKey(1)

    @jax.jit
    def random_step(states, key):
        lm = jax.vmap(legal_mask)(states)
        mv = jax.random.categorical(key, jnp.where(lm, 0.0, -1e9), axis=-1)
        nxt, _ = jax.vmap(step)(states, mv.astype(jnp.int32))
        return nxt

    for _ in range(60):
        key, k = jax.random.split(key)
        states = random_step(states, k)
    jax.block_until_ready(states.stones)

    for W in (4096, 15360):
        idx = jnp.arange(W) % B0
        sts = jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0),
                                     states)
        print(f"W={W}:", flush=True)
        lad = jax.jit(jax.vmap(laddered_stones))
        timeit("laddered_stones", lad, sts)
        f_off = jax.jit(lambda s: batched_features(s, False))
        f_on = jax.jit(lambda s: batched_features(s, True))
        t0 = timeit("features ladders OFF", f_off, sts)
        t1 = timeit("features ladders ON", f_on, sts)
        print(f"  => ladder-plane cost at W={W}: {t1 - t0:.1f} ms "
              f"({(t1 - t0) / max(t0, 1e-9) * 100:.0f}% of featurize)",
              flush=True)


if __name__ == "__main__":
    main()
