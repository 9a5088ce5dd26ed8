"""Ladder-blindness strength evidence (VERDICT r4 item 6).

The reference feeds exact ladder planes 13-14 to the net on every query
(go_features.cc:38-62); this repo's production nets are ladder-blind
(planes off: the ladder reader is far too costly inside the search
sweep, benchmarks/ladder_cost.py). This probe measures what blindness costs on
the canonical decision ladders exist for: the DEFENDER's escape choice.

Setup: white stone at (r, c) in atari against a black N/W driving wall —
the textbook ladder toward the SE edge (tests/test_ladder.py geometry).
Two conditions per position:
  - WORKING ladder (no breaker): escaping loses the whole chase line;
    correct play = sacrifice (anything but the liberty).
  - BROKEN ladder (breaker stone on the chase diagonal, beyond the
    search's read-out horizon where geometry allows): escaping saves the
    stone; correct play = the liberty.
Ground truth is the construction itself, sanity-checked per position with
game/ladder.laddered_stones (positions where the greedy reader disagrees
with the construction are dropped and reported).

A ladder-AWARE evaluator discriminates: escape rate ~0 on working
ladders, ~1 on broken ones. A blind evaluator shows similar rates in
both conditions (the search can still read SHORT ladders in-tree;
breaker distance is recorded so horizon effects are visible).

Reports, per tier (fast n=32/k=5 g=4; selected n=128/k=8 g=4 with
--selected) and for the raw policy: escape rates by condition + the
discrimination gap.

Usage:
  PYTHONPATH= JAX_PLATFORMS=cpu python benchmarks/ladder_strength.py [ckpt]
  (CPU is fine: B=32 positions x 8 seeds at fast-tier widths)
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SEEDS = 8


def build_positions():
    """Returns (dsl_list, meta): atari'd textbook ladders, +/- breaker."""
    from p3achygo_tpu.constants import BOARD_LEN

    positions, meta = [], []
    for r in (3, 4, 5, 6):
        for c in (3, 4, 5, 6):
            # Textbook shape (tests/test_ladder.py) + the attacker's first
            # atari from the S: white's single liberty is E, the extension
            # keeps 2 libs and the chase zigzags toward the SE edge.
            base_black = {(r - 1, c): "x", (r, c - 1): "x",
                          (r - 1, c + 1): "x", (r + 1, c): "x"}
            white = {(r, c): "o"}
            d = min(10, BOARD_LEN - 2 - max(r, c))  # breaker depth on diag
            for breaker in (False, True):
                w = dict(white)
                if breaker:
                    w[(r + d, c + d)] = "o"
                positions.append((base_black, w))
                meta.append(dict(r=r, c=c, breaker=breaker, d=d,
                                 lib=r * BOARD_LEN + (c + 1)))
    return positions, meta


def grid_dsl(*stones_by_color):
    g = [["." for _ in range(19)] for _ in range(19)]
    for dct in stones_by_color:
        for (i, j), ch in dct.items():
            g[i][j] = ch
    return "\n".join(" ".join(row) for row in g)


def main():
    import jax
    import jax.numpy as jnp

    from p3achygo_tpu.constants import WHITE
    from p3achygo_tpu.game import board_from_dsl
    from p3achygo_tpu.game.ladder import laddered_stones
    from p3achygo_tpu.mcts.gumbel import (SearchParams, make_eval_fn,
                                          search_root)
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.train.checkpoint import restore_checkpoint

    ckpt = sys.argv[1] if len(sys.argv) > 1 else "runs/curve-r4/model_0003"
    selected = "--selected" in sys.argv

    positions, meta = build_positions()
    states_l = [board_from_dsl(grid_dsl(b, w), to_move=WHITE)
                for b, w in positions]
    states = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states_l)
    B = len(meta)

    # Label sanity: greedy reader must agree with the construction.
    lad = jax.vmap(laddered_stones)(states)  # [B, 361]
    keep = []
    for i, m in enumerate(meta):
        is_lad = bool(np.asarray(lad[i]).reshape(-1)[m["r"] * 19 + m["c"]])
        if is_lad == (not m["breaker"]):
            keep.append(i)
        else:
            print(f"  drop ({m['r']},{m['c']}) breaker={m['breaker']}: "
                  f"reader disagrees", flush=True)
    print(f"positions kept: {len(keep)}/{B}", flush=True)

    model = build_model(get_config("b8c64"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    if os.path.isdir(ckpt):
        tmpl = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "step": jnp.zeros((), jnp.int32)}
        full = restore_checkpoint(ckpt, tmpl)
        variables = {"params": full["params"],
                     "batch_stats": full["batch_stats"]}
        print(f"weights: {ckpt}", flush=True)
    else:
        print("weights: random-init", flush=True)
    eval_fn = make_eval_fn(model, variables)

    n, k = (128, 8) if selected else (32, 5)
    params = SearchParams(n=n, k=k, noise_scale=1.0, max_depth=24,
                          visit_group=4)

    @jax.jit
    def one_seed(key):
        res = search_root(key, states, eval_fn, params,
                          tau=jnp.zeros((B,)))
        return res.mcts_move, res.root_priors

    libs = jnp.asarray([m["lib"] for m in meta])
    esc_search = np.zeros((B,), np.float64)
    prior_esc = None
    for s in range(SEEDS):
        mv, priors = one_seed(jax.random.PRNGKey(100 + s))
        esc_search += np.asarray(mv == libs, np.float64)
        if prior_esc is None:
            prior_esc = np.asarray(priors[jnp.arange(B), libs])
    esc_search /= SEEDS

    keep = np.asarray(keep)
    brk = np.asarray([meta[i]["breaker"] for i in keep])
    es = esc_search[keep]
    ep = prior_esc[keep]
    tier = f"selected n={n} k={k}" if selected else f"fast n={n} k={k}"
    print(f"\n[{tier}, g=4, {SEEDS} seeds x {len(keep)} positions, "
          f"ckpt={os.path.basename(ckpt)}]")
    print(f"  search escape rate: working={es[~brk].mean():.3f} "
          f"broken={es[brk].mean():.3f} "
          f"discrimination={es[brk].mean() - es[~brk].mean():+.3f}")
    print(f"  raw-policy P(escape): working={ep[~brk].mean():.3f} "
          f"broken={ep[brk].mean():.3f} "
          f"discrimination={ep[brk].mean() - ep[~brk].mean():+.3f}")
    for i in keep:
        m = meta[i]
        print(f"    ({m['r']},{m['c']}) d={m['d']} breaker={m['breaker']}: "
              f"search={esc_search[i]:.2f} prior={prior_esc[i]:.3f}")


if __name__ == "__main__":
    main()
