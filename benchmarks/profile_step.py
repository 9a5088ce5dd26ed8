"""Profile the full selfplay step on the chip; aggregate hot fusions.

Usage: python benchmarks/profile_step.py  (GPU, one process)
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)



def main():
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
    from p3achygo_tpu.mcts.tree import make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (
        SelfplayConfig, make_aux, make_game_buffer, selfplay_step)

    B = 1024
    cfg = SelfplayConfig(batch_size=B)
    params = SearchParams(n=32, k=4, noise_scale=1.0, max_depth=24)
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)
    reuse_capacity = params.n + 2

    @jax.jit
    def sp_step(states, buf, aux, tree, key):
        return selfplay_step(states, buf, aux, key, eval_fn, params, cfg,
                             selected_tier=True, reuse_tree=tree,
                             reuse_capacity=reuse_capacity)

    states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B))
    buf = make_game_buffer(B, cfg.max_game_len)
    key = jax.random.PRNGKey(1)
    key, kaux = jax.random.split(key)
    aux = make_aux(kaux, B)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, reuse_capacity)

    # Warm up + play some moves so the profile reflects mid-game trees.
    for i in range(10):
        states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)

    t0 = time.time()
    for _ in range(4):
        states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)
    per_step_ms = (time.time() - t0) / 4 * 1000
    print(f"per-step: {per_step_ms:.1f} ms  ({B/ (per_step_ms/1000):.0f} moves/s)")

    outdir = "/tmp/prof_step"
    with jax.profiler.trace(outdir):
        for _ in range(2):
            states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
        jax.block_until_ready(states.stones)
    print("trace written to", outdir)


if __name__ == "__main__":
    main()
