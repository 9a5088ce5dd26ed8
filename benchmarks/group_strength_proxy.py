"""Strength validation for grouped visits: visit_group=G vs =1, same net.

Both players share the same weights; search quality is measured as
head-to-head winrate under the eval harness (the search that better
optimizes the net's own value function wins more).

Round-4 rewrite (VERDICT r3 weak #2): the round-2 version hard-coded
noise_scale=0.0 with tau=0 — exactly the degenerate mode the gating-bug
fix documents (every game of a color half identical, eval/harness.py) —
so its "64 games" carried ~2 games of information. Now: root Gumbel
noise ON (1.0, matching all match play), TRAINED weights (runs/curve15
model_0007 golden by default; random-init fallback), >= 256 games, and
BOTH production tiers (selected n=128/k=8, fast n=32/k=5 — bench.py's
reference mix).

Usage: python benchmarks/group_strength_proxy.py [G] [games] [ckpt|random]
       [tiers: both|selected|fast]   (GPU, one process)
"""
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


# Trained-weights default: the newest golden of a local curve run
# (checkpoints are made at run time under runs/; none are committed).
def _default_ckpt():
    for root in ("runs/curve-r4", "runs/curve15"):
        base = os.path.join(os.path.dirname(__file__), "..", root)
        if not os.path.isdir(base):
            continue
        models = sorted(d for d in os.listdir(base) if d.startswith("model_"))
        if models:
            return os.path.join(base, models[-1])
    return "random"


DEFAULT_CKPT = _default_ckpt()


def main():
    from p3achygo_tpu.eval.harness import EvalConfig, EvalRunner
    from p3achygo_tpu.eval.player_config import PlayerSearchConfig
    from p3achygo_tpu.mcts.gumbel import SearchParams
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.train.checkpoint import restore_checkpoint

    G = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    games = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    ckpt = sys.argv[3] if len(sys.argv) > 3 else DEFAULT_CKPT
    tiers = sys.argv[4] if len(sys.argv) > 4 else "both"

    model = build_model(get_config("b8c64"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(7))
    if ckpt != "random" and os.path.isdir(ckpt):
        tmpl = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "step": jnp.zeros((), jnp.int32)}
        full = restore_checkpoint(ckpt, tmpl)
        variables = {"params": full["params"],
                     "batch_stats": full["batch_stats"]}
        print(f"weights: {ckpt}", flush=True)
    else:
        print("weights: random-init", flush=True)

    for tier, (n, k) in (("selected", (128, 8)), ("fast", (32, 5))):
        if tiers != "both" and tier != tiers:
            continue
        cfg = EvalConfig(
            num_games=games, max_game_len=220,
            search=SearchParams(n=n, k=k, noise_scale=1.0, tau=0.0),
            cand=PlayerSearchConfig(n=n, k=k, noise_scale=1.0,
                                    visit_group=G),
            cur=PlayerSearchConfig(n=n, k=k, noise_scale=1.0,
                                   visit_group=1))
        runner = EvalRunner(model, cfg)
        res = runner.run(jax.random.PRNGKey(1), variables, variables)
        print(f"[{tier} n={n} k={k}] visit_group={G} vs 1: "
              f"winrate={res.winrate:.3f} elo={res.elo:+.1f} "
              f"[{res.elo_lo:+.1f},{res.elo_hi:+.1f}] "
              f"({games} games, resign {res.by_resign})", flush=True)


if __name__ == "__main__":
    main()
