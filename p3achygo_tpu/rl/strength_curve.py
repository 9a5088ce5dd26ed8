"""Multi-generation strength-curve run + transitive anchor matches.

The reference's evidence that the loop trains is its runs log
(notes/runs.md:33-234: v1..v3 strength vs external engines across
hundreds of generations). This driver produces the equivalent artifact
for a local run: N generations of the full RL loop (selfplay -> train ->
SWA -> gate -> promote, rl/loop.py GenerationLoop) with per-generation
metrics, then TRANSITIVE ANCHOR MATCHES — final golden vs gen-0 and vs
the mid-run golden, played directly (not chained through gating) with
the eval harness (eval/harness.py; train_sp_eval.py:229-238 gating
protocol) — expecting monotone improvement.

Resumable: generations checkpoint after each gen (GenerationLoop
save_resume), so the run can be interrupted and continued with the same
command.

Usage:
  python -m p3achygo_tpu.rl.strength_curve --config config/<run>.json \
      --run-dir runs/<name> [--gens 15] [--anchor-games 64] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import time


def anchor_match(model, cfg, cand_vars, cur_vars, num_games: int,
                 n: int, k: int, max_game_len: int, seed: int):
    """Direct match between two checkpoints -> EvalResult."""
    import jax

    from p3achygo_tpu.eval.harness import EvalConfig, EvalRunner

    ev_cfg = EvalConfig(num_games=num_games, max_game_len=max_game_len,
                        search=__import__(
                            "p3achygo_tpu.mcts.gumbel",
                            fromlist=["SearchParams"]).SearchParams(
                            n=n, k=k, noise_scale=1.0, tau=0.0))
    runner = EvalRunner(model, ev_cfg)
    return runner.run(jax.random.PRNGKey(seed), cand_vars, cur_vars)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--gens", type=int, default=15)
    ap.add_argument("--anchor-games", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-anchors", action="store_true")
    ap.add_argument("--anchors-only", action="store_true")
    args = ap.parse_args()

    from p3achygo_tpu import compile_cache

    compile_cache.enable(min_compile_secs=5)

    from p3achygo_tpu.models import init_params
    from p3achygo_tpu.rl.config import parse
    from p3achygo_tpu.rl.loop import GenerationLoop
    from p3achygo_tpu.train.checkpoint import restore_checkpoint, save_named

    cfg = parse(args.config)
    loop = GenerationLoop(cfg, root_dir=args.run_dir, seed=args.seed)
    resumed = loop.try_resume()
    print(f"run {args.run_dir}: gen={loop.gen} resumed={resumed}",
          flush=True)

    # Keep the gen-0 (random init) weights as an anchor endpoint — the
    # normal checkpoint chain starts at model_0001.
    gen0_path = os.path.join(args.run_dir, "gen0")
    if not os.path.isdir(gen0_path):
        save_named(args.run_dir, "gen0", loop.golden)

    genlog = os.path.join(args.run_dir, "generations.jsonl")
    if not args.anchors_only:
        while loop.gen < args.gens:
            t0 = time.time()
            info = loop.run_generation()
            info["wall_s"] = round(time.time() - t0, 1)
            row = {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in info.items()}
            with open(genlog, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)

    if args.skip_anchors:
        return

    # --- transitive anchor matches ---
    final_gen = loop.gen
    mid_gen = max(final_gen // 2, 1)
    tmpl = loop.golden

    def load(gen):
        if gen == 0:
            return restore_checkpoint(gen0_path, tmpl)
        path = os.path.join(args.run_dir, f"model_{gen:04d}")
        full = restore_checkpoint(
            path, {"params": tmpl["params"],
                   "batch_stats": tmpl["batch_stats"],
                   "step": loop.train_state.step})
        return {"params": full["params"],
                "batch_stats": full["batch_stats"]}

    results = {}
    for name, a, b in (("final_vs_gen0", final_gen, 0),
                       ("final_vs_mid", final_gen, mid_gen),
                       ("mid_vs_gen0", mid_gen, 0)):
        res = anchor_match(loop.model, cfg, load(a), load(b),
                           args.anchor_games, n=cfg.eval_n, k=cfg.eval_k,
                           max_game_len=cfg.eval_max_game_len,
                           seed=args.seed + 100)
        results[name] = {
            "cand_gen": a, "cur_gen": b,
            "wins": float(res.cand_wins), "games": int(res.num_games),
            "winrate": round(float(res.winrate), 4),
            "elo": round(float(res.elo), 1),
            "elo_lo": round(float(res.elo_lo), 1),
            "elo_hi": round(float(res.elo_hi), 1),
        }
        print(name, json.dumps(results[name]), flush=True)

    with open(os.path.join(args.run_dir, "anchors.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("anchors written", flush=True)


if __name__ == "__main__":
    main()
