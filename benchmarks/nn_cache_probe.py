"""Cross-move NN cache probe (VERDICT item: nn_interface.h:206-228 LRU).

The reference keeps a per-thread 2^20-entry LRU keyed (hash, color) so NN
evals of positions revisited across moves are skipped. Here, tree reuse
already carries the played line's subtree (with its evals) to the next
move; this probe measures how many of the REMAINING evals (fresh
allocations) hit positions evaluated during the previous move's search —
the upper bound on what a device-side cross-move cache could save.

Method: run selfplay moves with tree reuse ON; after each move, collect
the (hash, color) keys of every evaluated node in the working tree (the
stored s_hash/color node state) and compute what fraction of THIS move's
newly-allocated evals appeared anywhere in the previous move's tree.

Usage: PYTHONPATH= JAX_PLATFORMS=cpu python benchmarks/nn_cache_probe.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn, search_root
    from p3achygo_tpu.mcts.tree import compact_subtree, make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params

    B = 8
    N_MOVES = 40
    RCAP = 34
    params = SearchParams(n=32, k=4, noise_scale=1.0, max_depth=16,
                          visit_group=4)
    model = build_model(get_config("tiny"))
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_fn = make_eval_fn(model, variables)

    @jax.jit
    def srch(key, states, tree):
        return search_root(key, states, eval_fn, params, init_tree=tree,
                           reuse_capacity=RCAP)

    from p3achygo_tpu.game.board import step

    states = jax.vmap(lambda _: new_state(7.5))(jnp.arange(B))
    tree = make_tree(B, RCAP)
    key = jax.random.PRNGKey(1)

    def tree_keys(t):
        """Per board: set of (hash0, hash1, color) of evaluated nodes."""
        ev = np.asarray(t.evaluated)
        h = np.asarray(t.s_hash)
        c = np.asarray(t.color)
        out = []
        for b in range(B):
            rows = np.flatnonzero(ev[b])
            out.append({(int(h[b, m, 0]), int(h[b, m, 1]), int(c[b, m]))
                        for m in rows})
        return out

    prev_keys = [set() for _ in range(B)]
    carried_keys = [set() for _ in range(B)]
    total_new, total_hits = 0, 0
    for mv in range(N_MOVES):
        key, ks = jax.random.split(key)
        res, work = srch(ks, states, tree)
        cur = tree_keys(work)
        for b in range(B):
            # "new" evals this move = evaluated nodes not carried in by
            # tree reuse; "hits" = those already seen in the previous
            # move's FULL tree (what an LRU would have retained).
            new = cur[b] - carried_keys[b]
            hits = new & prev_keys[b]
            total_new += len(new)
            total_hits += len(hits)
        move = res.mcts_move
        tree = compact_subtree(work, move, RCAP)
        carried_keys = tree_keys(tree)
        prev_keys = cur
        states, _ = jax.vmap(step)(states, move)

    rate = total_hits / max(total_new, 1)
    print(f"cross-move NN cache probe: {total_hits}/{total_new} fresh evals "
          f"({100*rate:.1f}%) were present in the previous move's tree "
          f"(n={params.n} k={params.k} g={params.visit_group}, {N_MOVES} "
          f"moves, {B} boards, reuse ON)")


if __name__ == "__main__":
    main()
