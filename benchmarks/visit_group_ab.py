"""Strength A/B: visit_group g=4 vs g=1 at production tiers, trained net.

VERDICT r2 weak #4: the g=4 default rests on a 64-game random-init proxy
at n=32 (CI +-87 Elo). This harness plays a >=500-game match with a
TRAINED checkpoint at BOTH production tiers (n=128/k=8 and n=32/k=5):
one side searches with visit_group=4, the other with visit_group=1,
same weights, color-balanced.

Usage (GPU, one process; expects a trained run dir):
  python benchmarks/visit_group_ab.py --run-dir runs/curve15 \
      --games 512 --tier fast|selected
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--games", type=int, default=512)
    ap.add_argument("--tier", choices=("fast", "selected"), default="fast")
    ap.add_argument("--model-config", default="b8c64")
    args = ap.parse_args()

    from p3achygo_tpu.eval.harness import EvalConfig, EvalRunner
    from p3achygo_tpu.eval.player_config import PlayerSearchConfig
    from p3achygo_tpu.mcts.gumbel import SearchParams
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.train.checkpoint import (latest_generation,
                                               restore_checkpoint)

    model = build_model(get_config(args.model_config), dtype=jnp.bfloat16)
    tmpl = init_params(model, jax.random.PRNGKey(0))
    gen = latest_generation(args.run_dir)
    assert gen is not None, "no model_%04d checkpoints in run dir"
    path = os.path.join(args.run_dir, f"model_{gen:04d}")
    print(f"loading {path} (gen {gen})")
    full = restore_checkpoint(path, {"params": tmpl["params"],
                                     "batch_stats": tmpl["batch_stats"],
                                     "step": jnp.zeros([], jnp.int32)})
    vars_ = {"params": full["params"], "batch_stats": full["batch_stats"]}

    n, k = (128, 8) if args.tier == "selected" else (32, 5)
    p4 = PlayerSearchConfig(n=n, k=k, visit_group=4, noise_scale=1.0)
    p1 = PlayerSearchConfig(n=n, k=k, visit_group=1, noise_scale=1.0)
    cfg = EvalConfig(num_games=args.games, max_game_len=450,
                     search=p4.to_search_params(), cand=p4, cur=p1)
    runner = EvalRunner(model, cfg)
    res = runner.run(jax.random.PRNGKey(42), vars_, vars_)
    print(f"tier={args.tier} n={n} k={k} games={res.num_games}: "
          f"g4 wins {res.cand_wins} ({res.winrate:.3f}), "
          f"elo {res.elo:+.1f} [{res.elo_lo:+.1f}, {res.elo_hi:+.1f}]")


if __name__ == "__main__":
    main()
