"""Break down the tiered selfplay step (bench.py workload) on the chip.

Times each piece separately:
  - full tiered step (ES off / ES on)
  - selected-tier search alone (B=256, n=128 k=8, reuse)
  - fast-tier search alone (B=768, n=32 k=5, reuse)
  - compact_subtree at the two widths
  - tree gather/scatter (the tier permutation)

Usage: python benchmarks/profile_tiered.py  (GPU, one process)
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
    print(f"{name}: {ms:.1f} ms")
    return ms


def main():
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
    from p3achygo_tpu.mcts.tree import compact_subtree, make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (
        SelfplayConfig, make_aux, make_game_buffer, selfplay_step,
        selfplay_step_tiered)

    B = 1024
    RCAP = 64
    cfg = SelfplayConfig(batch_size=B)
    p_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24, visit_group=4)
    p_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24, visit_group=4)
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)

    def make_tiered(es):
        ps = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                          early_stopping=es)
        pf = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                          early_stopping=es)

        @jax.jit
        def sp_step(states, buf, aux, tree, key):
            return selfplay_step_tiered(states, buf, aux, key, eval_fn, ps,
                                        pf, cfg, reuse_tree=tree,
                                        reuse_capacity=RCAP)
        return sp_step

    step_off = make_tiered(False)
    step_on = make_tiered(True)

    states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B))
    buf = make_game_buffer(B, cfg.max_game_len)
    key = jax.random.PRNGKey(1)
    key, kaux = jax.random.split(key)
    aux = make_aux(kaux, B)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, RCAP)

    # Play to mid-game (ply ~60) so trees/positions are realistic.
    for i in range(60):
        states, buf, aux, tree, key = step_off(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)
    print("reached ply", int(states.move_count[0]))

    t_full_off = timeit("tiered step ES=off", step_off, states, buf, aux,
                        tree, key)
    t_full_on = timeit("tiered step ES=on ", step_on, states, buf, aux,
                       tree, key)

    # Isolated tier searches at their sub-batch widths, from the same
    # mid-game states.
    from p3achygo_tpu.mcts.gumbel import search_root

    def sub(n):
        st = jax.tree_util.tree_map(lambda x: x[:n], states)
        tr = jax.tree_util.tree_map(lambda x: x[:n], tree)
        return st, tr

    for name, nb, params in (("selected n=128 k=8 @256", 256, p_sel),
                             ("fast     n=32  k=5 @768", 768, p_fast)):
        st, tr = sub(nb)

        @jax.jit
        def srch(st, tr, key, params=params):
            res, work = search_root(key, st, eval_fn, params, init_tree=tr,
                                    reuse_capacity=RCAP)
            return res.mcts_move, work.n

        timeit(f"search {name}", srch, st, tr, key)

        @jax.jit
        def srch_es(st, tr, key, params=params):
            import dataclasses
            p = dataclasses.replace(params, early_stopping=True)
            res, work = search_root(key, st, eval_fn, p, init_tree=tr,
                                    reuse_capacity=RCAP)
            return res.mcts_move, work.n

        timeit(f"search {name} ES=on", srch_es, st, tr, key)

    # compact_subtree cost at working-tree width (selected tier).
    st, tr = sub(256)

    @jax.jit
    def search_and_compact(st, tr, key):
        res, work = search_root(key, st, eval_fn, p_sel, init_tree=tr,
                                reuse_capacity=RCAP)
        return compact_subtree(work, res.mcts_move, RCAP)

    timeit("selected search+compact @256", search_and_compact, st, tr, key)

    # Tier permutation gather/scatter of states+buf+tree.
    @jax.jit
    def permute(states, buf, tree, key):
        perm = jax.random.permutation(key, B)
        take = lambda x: jnp.take(x, perm, axis=0)
        s2 = jax.tree_util.tree_map(take, states)
        t2 = jax.tree_util.tree_map(take, tree)
        b2 = jax.tree_util.tree_map(take, buf)
        return s2.stones.sum(), t2.n.sum(), b2.pi.sum()

    timeit("full permute states+tree+buf", permute, states, buf, tree, key)

    @jax.jit
    def permute_nobuf(states, tree, key):
        perm = jax.random.permutation(key, B)
        take = lambda x: jnp.take(x, perm, axis=0)
        s2 = jax.tree_util.tree_map(take, states)
        t2 = jax.tree_util.tree_map(take, tree)
        return s2.stones.sum(), t2.n.sum()

    timeit("permute states+tree only   ", permute_nobuf, states, tree, key)


if __name__ == "__main__":
    main()
