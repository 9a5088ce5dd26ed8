"""Trace one mid-game tier search; aggregate hot fusions from the profile.

Usage: python benchmarks/trace_search.py [sel|fast]  (GPU, one process)
"""
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)



def aggregate(outdir):
    files = glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                      recursive=True)
    assert files, f"no trace under {outdir}"
    latest = max(files, key=os.path.getmtime)
    with gzip.open(latest, "rt") as f:
        trace = json.load(f)
    # Keep device op events only (pid of device track).
    by_name = defaultdict(float)
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if "run_id" in args or "program_id" in args or True:
            cat = ev.get("cat", "")
        dur = ev.get("dur", 0) / 1e3  # ms
        tid_name = str(ev.get("tid", ""))
        if "fusion" in name or "copy" in name or "convolution" in name \
                or "dynamic" in name or "while" in name or "scatter" in name \
                or "all-reduce" in name or "custom" in name or "loop_" in name:
            key = name.split(".")[0]
            by_name[key] += dur
            total += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:40]
    print(f"total attributed: {total:.1f} ms over {len(by_name)} op groups")
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name}")


def main():
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn, search_root
    from p3achygo_tpu.mcts.tree import make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (
        SelfplayConfig, make_aux, make_game_buffer, selfplay_step_tiered)

    which = sys.argv[1] if len(sys.argv) > 1 else "fast"
    B = 1024
    RCAP = 64
    cfg = SelfplayConfig(batch_size=B)
    p_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24, visit_group=4)
    p_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24, visit_group=4)
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)

    @jax.jit
    def sp_step(states, buf, aux, tree, key):
        return selfplay_step_tiered(states, buf, aux, key, eval_fn, p_sel,
                                    p_fast, cfg, reuse_tree=tree,
                                    reuse_capacity=RCAP)

    states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B))
    buf = make_game_buffer(B, cfg.max_game_len)
    key = jax.random.PRNGKey(1)
    key, kaux = jax.random.split(key)
    aux = make_aux(kaux, B)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, RCAP)
    for i in range(60):
        states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
    jax.block_until_ready(states.stones)

    if which == "sel":
        nb, params = 256, p_sel
    else:
        nb, params = 768, p_fast
    st = jax.tree_util.tree_map(lambda x: x[:nb], states)
    tr = jax.tree_util.tree_map(lambda x: x[:nb], tree)

    @jax.jit
    def srch(st, tr, key):
        res, work = search_root(key, st, eval_fn, params, init_tree=tr,
                                reuse_capacity=RCAP)
        return res.mcts_move, work.n

    out = srch(st, tr, key)
    jax.block_until_ready(out)
    t0 = time.time()
    out = srch(st, tr, key)
    jax.block_until_ready(out)
    print(f"{which} search: {(time.time()-t0)*1000:.1f} ms")

    outdir = f"/tmp/prof_search_{which}"
    with jax.profiler.trace(outdir):
        out = srch(st, tr, key)
        jax.block_until_ready(out)
    aggregate(outdir)


if __name__ == "__main__":
    main()
