"""Decompose the per-sweep cost of the tiered search at HEAD.

Times, at REAL mid-game tier shapes (fast: B=768 n=32 k=5 g=4 reuse-64;
selected: B=256 n=128 k=8 g=4 reuse-64):

  - full search (real NN) vs full search (dummy NN)  -> NN-side cost
  - _sweep_action_table (no transitions / with transitions)
  - the leaf-parent state gather einsums (one_sweep's g_fx block)
  - eval_fn at the exact sweep widths
  - vmap(step) + legal_mask_batch at sweep width

Usage: python benchmarks/decompose_sweep.py [fast|sel]  (GPU, one process)
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
    from p3achygo_tpu.game.board import (GoState, legal_mask, new_state,
                                         legal_mask_batch, step)
    from p3achygo_tpu.mcts.gumbel import (SearchParams, make_eval_fn,
                                          search_root, uniform_eval_fn,
                                          _sweep_action_table)
    from p3achygo_tpu.mcts.tree import make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (
        SelfplayConfig, make_aux, make_game_buffer, selfplay_step_tiered)

    which = sys.argv[1] if len(sys.argv) > 1 else "fast"
    B0 = 1024
    RCAP = 64
    cfg = SelfplayConfig(batch_size=B0)
    p_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                         visit_group=4)
    p_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                          visit_group=4)
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)

    @jax.jit
    def sp_step(states, buf, aux, tree, key):
        return selfplay_step_tiered(states, buf, aux, key, eval_fn, p_sel,
                                    p_fast, cfg, reuse_tree=tree,
                                    reuse_capacity=RCAP)

    states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B0))
    buf = make_game_buffer(B0, cfg.max_game_len)
    key = jax.random.PRNGKey(1)
    key, kaux = jax.random.split(key)
    aux = make_aux(kaux, B0)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B0, RCAP)
    print("warmup 60 plies...", flush=True)
    for i in range(60):
        states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)

    nb, params = (256, p_sel) if which == "sel" else (768, p_fast)
    st = jax.tree_util.tree_map(lambda x: x[:nb], states)
    tr = jax.tree_util.tree_map(lambda x: x[:nb], tree)
    print(f"--- tier {which}: B={nb} n={params.n} k={params.k} g=4 ---",
          flush=True)

    def srch(evf):
        @jax.jit
        def f(st, tr, key):
            res, work = search_root(key, st, evf, params, init_tree=tr,
                                    reuse_capacity=RCAP)
            return res.mcts_move, work.n
        return f

    t_real = timeit("search real NN", srch(eval_fn), st, tr, key, iters=4)
    t_dummy = timeit("search dummy NN", srch(uniform_eval_fn), st, tr, key,
                     iters=4)
    print(f"  => NN-side cost: {t_real - t_dummy:.1f} ms", flush=True)

    # A realistic WORKING tree for component timing.
    @jax.jit
    def get_work(st, tr, key):
        res, work = search_root(key, st, eval_fn, params, init_tree=tr,
                                reuse_capacity=RCAP)
        return work
    work = get_work(st, tr, key)
    jax.block_until_ready(work.n)
    N = work.n.shape[1]
    print(f"  working tree N={N}", flush=True)

    tab1 = jax.jit(lambda t: _sweep_action_table(t, 50.0, 1.0, 4))
    tab2 = jax.jit(lambda t: _sweep_action_table(t, 50.0, 1.0, 4,
                                                 with_transitions=True))
    timeit("action table (acts only)", tab1, work)
    timeit("action table (+transitions)", tab2, work)

    # Leaf-parent state gather (the g_fx block of one_sweep).
    L = params.k * 4
    W = nb * L

    @jax.jit
    def leaf_gather(work, par_sel):
        oh_par = jax.nn.one_hot(par_sel, N, dtype=jnp.float32)
        g_f = lambda arr: jnp.einsum(
            "bln,bn->bl", oh_par, arr.astype(jnp.float32)).reshape(-1)
        g_fx = lambda arr: jnp.einsum(
            "bln,bnx->blx", oh_par,
            arr.astype(jnp.float32)).reshape(W, arr.shape[-1])
        gu32 = lambda arr: (
            (g_fx((arr >> jnp.uint32(16)).astype(jnp.int32))
             .astype(jnp.uint32) << jnp.uint32(16))
            | g_fx((arr & jnp.uint32(0xFFFF)).astype(jnp.int32))
            .astype(jnp.uint32))
        return (g_fx(work.s_stones).astype(jnp.int8),
                g_fx(work.s_chain).astype(jnp.int32),
                gu32(work.s_hash),
                g_fx(work.s_last5).astype(jnp.int32),
                g_f(work.s_ko).astype(jnp.int32),
                g_f(work.color).astype(jnp.int8),
                g_fx(work.s_legal) > 0.5)

    par = jnp.zeros((nb, L), jnp.int32)
    timeit("leaf state gather einsums", leaf_gather, work, par)

    # Board step + legality + eval at sweep width.
    idx = jnp.arange(W) % nb
    stw = jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0), st)

    @jax.jit
    def step_legal(stw):
        nxt, _ = jax.vmap(step)(stw, jnp.full((W,), 60, jnp.int32))
        return legal_mask_batch(nxt)

    timeit(f"vmap(step)+legal at W={W}", step_legal, stw)
    ev = jax.jit(lambda s: eval_fn(s))
    timeit(f"eval_fn(real) at W={W}", ev, stw)

    from p3achygo_tpu.game.board import point_liberties_batch
    libs = jax.jit(lambda s: point_liberties_batch(s.stones, s.chain_id))
    timeit(f"point_liberties at W={W}", libs, stw)

    from p3achygo_tpu.features import batched_features
    feats = jax.jit(lambda s: batched_features(s, False))
    timeit(f"batched_features at W={W}", feats, stw)

    @jax.jit
    def model_only(planes, scalars):
        return model.apply(variables, planes, scalars, train=False)
    planes, scalars = feats(stw)
    jax.block_until_ready(planes)
    timeit(f"model.apply at W={W}", model_only, planes, scalars)


if __name__ == "__main__":
    main()
