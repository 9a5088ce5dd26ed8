"""Sweep SearchParams.visit_group on the chip: search latency vs g.

Times the two production tier searches (selected n=128 k=8 @B=256, fast
n=32 k=5 @B=768, mid-game trees, reuse on) at g in {1, 4, 8, 16} to map
the grouped-visit lever (gumbel.py SearchParams.visit_group). Strength
impact is measured separately by benchmarks/group_strength_proxy.py.

Usage: python benchmarks/sweep_visit_group.py  (GPU, one process)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)



def timeit(name, fn, *args, iters=4):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.time() - t0) / iters * 1000
    print(f"{name}: {ms:.1f} ms", flush=True)
    return ms


def main():
    import dataclasses

    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import (SearchParams, make_eval_fn,
                                          search_root)
    from p3achygo_tpu.mcts.tree import make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (SelfplayConfig, make_aux,
                                            make_game_buffer,
                                            selfplay_step_tiered)

    B = 1024
    RCAP = 64
    cfg = SelfplayConfig(batch_size=B)
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)

    ps = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                      visit_group=4)
    pf = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                      visit_group=4)

    @jax.jit
    def warm_step(states, buf, aux, tree, key):
        return selfplay_step_tiered(states, buf, aux, key, eval_fn, ps, pf,
                                    cfg, reuse_tree=tree,
                                    reuse_capacity=RCAP)

    states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B))
    buf = make_game_buffer(B, cfg.max_game_len)
    key = jax.random.PRNGKey(1)
    key, kaux = jax.random.split(key)
    aux = make_aux(kaux, B)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, RCAP)
    for _ in range(60):
        states, buf, aux, tree, key = warm_step(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)
    print("reached ply", int(states.move_count[0]), flush=True)

    def sub(n):
        st = jax.tree_util.tree_map(lambda x: x[:n], states)
        tr = jax.tree_util.tree_map(lambda x: x[:n], tree)
        return st, tr

    for name, nb, base in (("selected n=128 k=8 @256", 256, ps),
                           ("fast     n=32  k=5 @768", 768, pf)):
        st, tr = sub(nb)
        for g in (1, 4, 8, 16):
            p = dataclasses.replace(base, visit_group=g)

            @jax.jit
            def srch(st, tr, key, params=p):
                res, work = search_root(key, st, eval_fn, params,
                                        init_tree=tr, reuse_capacity=RCAP)
                return res.mcts_move, work.n

            timeit(f"{name} g={g:2d}", srch, st, tr, key)


if __name__ == "__main__":
    main()
