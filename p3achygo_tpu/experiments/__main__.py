"""Experiments CLI (cc/experiments/main.cc + gumbel_visits_study.cc flags).

  python -m p3achygo_tpu.experiments play_games \
      --model_path runs/demo/models/model_0001 --num_games 4 \
      --visit_count 64 --seq_halving --bias_callback

  python -m p3achygo_tpu.experiments visits_study \
      --model_path runs/demo/models/model_0001 \
      --chunk_path runs/demo/chunks/chunk_0001.tfrecord.zz \
      --num_examples 64 --seed_visits 30 --gt_n 2048

`--model_path` is a checkpoint dir (train/checkpoint.py; the reference's
exported engine files have no counterpart here); `--model_config` + no
model_path runs a random-init net (useful for harness smoke tests).
"""
from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp


def _load_eval_fn(model_path: str, model_config: str):
    from p3achygo_tpu.mcts.gumbel import make_eval_fn
    from p3achygo_tpu.models import build_model, get_config, init_params
    model = build_model(get_config(model_config), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    if model_path:
        from p3achygo_tpu.train.checkpoint import restore_checkpoint
        variables = restore_checkpoint(model_path, variables)
    return make_eval_fn(model, variables)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="p3achygo_tpu.experiments")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pg = sub.add_parser("play_games")
    pg.add_argument("--model_path", default="")
    pg.add_argument("--model_config", default="b8c64")
    pg.add_argument("--num_games", type=int, default=1)
    pg.add_argument("--visit_count", type=int, default=400)
    pg.add_argument("--seq_halving", action="store_true")
    pg.add_argument("--bias_callback", action="store_true")
    pg.add_argument("--print_callback", action="store_true", default=True)
    pg.add_argument("--max_moves", type=int, default=600)
    pg.add_argument("--seed", type=int, default=0)

    vs = sub.add_parser("visits_study")
    vs.add_argument("--model_path", default="")
    vs.add_argument("--model_config", default="b8c64")
    vs.add_argument("--chunk_path", required=True)
    vs.add_argument("--num_examples", type=int, default=500)
    vs.add_argument("--batch", type=int, default=64)
    vs.add_argument("--seed_visits", type=int, default=30)
    vs.add_argument("--gt_n", type=int, default=10000,
                    help="ground-truth visit budget (gumbel_visits_study"
                         ".cc:87 uses 10000; smaller fits tighter HBM)")
    vs.add_argument("--n_values", default="64,100,150,200,300,400,800")
    vs.add_argument("--use_gumbel", action=argparse.BooleanOptionalAction,
                    default=True)
    vs.add_argument("--verbose", action="store_true")
    vs.add_argument("--seed", type=int, default=0)

    args = parser.parse_args(argv)
    eval_fn = _load_eval_fn(args.model_path, args.model_config)

    if args.cmd == "play_games":
        from p3achygo_tpu.experiments.play_games import (BiasCallback,
                                                         PrintCallback,
                                                         play_games)
        cbs = []
        if args.print_callback:
            cbs.append(PrintCallback())
        if args.bias_callback:
            cbs.append(BiasCallback())
        results = play_games(eval_fn, args.num_games, args.visit_count,
                             args.seq_halving, cbs,
                             max_moves=args.max_moves, seed=args.seed)
        for r in results:
            print(f"game {r.game_idx}: {r} in {r.num_moves} moves")
        return 0

    # visits_study
    from p3achygo_tpu.experiments.visits_study import (format_report,
                                                       load_chunk_examples,
                                                       run_visits_study,
                                                       states_from_examples)
    import numpy as np
    examples = load_chunk_examples(args.chunk_path, args.num_examples)
    if not examples:
        print(f"no examples in {args.chunk_path}", file=sys.stderr)
        return 1
    n_values = [int(x) for x in args.n_values.split(",") if x]

    # Process in device-sized batches and pool the per-position KLD
    # samples across batches (the reference streams one example at a
    # time; stats are over the pooled samples either way).
    reports = []
    for lo in range(0, len(examples), args.batch):
        chunk = examples[lo:lo + args.batch]
        states = states_from_examples(chunk)
        reports.append(run_visits_study(
            eval_fn, states, n_values=n_values, gt_n=args.gt_n,
            seed_visits=args.seed_visits, use_gumbel=args.use_gumbel,
            seed=args.seed + lo))
        print(f"processed {min(lo + args.batch, len(examples))}"
              f"/{len(examples)} examples", file=sys.stderr)

    # Pool: recompute summary stats over concatenated samples is not
    # possible from the stats dicts alone, so weight batch means by size
    # and take max-of-max / max-of-p95 as conservative aggregates.
    def pool(rows_key):
        total = sum(r["examples"] for r in reports)
        mean = sum(r[rows_key]["mean"] * r["examples"]
                   for r in reports) / total
        return {"mean": mean,
                "p75": max(r[rows_key]["p75"] for r in reports),
                "p95": max(r[rows_key]["p95"] for r in reports),
                "max": max(r[rows_key]["max"] for r in reports)}

    agg = dict(reports[0])
    agg["examples"] = sum(r["examples"] for r in reports)
    agg["prior"] = pool("prior")
    per_n = []
    total = agg["examples"]
    for ni, n in enumerate(n_values):
        mean_gt = sum(r["per_n"][ni]["kld_gt"]["mean"] * r["examples"]
                      for r in reports) / total
        mean_pd = sum(r["per_n"][ni]["kld_prior"]["mean"] * r["examples"]
                      for r in reports) / total
        per_n.append({
            "n": n,
            "kld_gt": {"mean": mean_gt,
                       "p75": max(r["per_n"][ni]["kld_gt"]["p75"]
                                  for r in reports),
                       "p95": max(r["per_n"][ni]["kld_gt"]["p95"]
                                  for r in reports),
                       "max": max(r["per_n"][ni]["kld_gt"]["max"]
                                  for r in reports)},
            "kld_prior": {"mean": mean_pd, "p75": 0.0, "p95": 0.0,
                          "max": 0.0},
            "nats_per_visit": (agg["prior"]["mean"] - mean_gt) / n,
        })
    agg["per_n"] = per_n
    print(format_report(agg))
    return 0


if __name__ == "__main__":
    from p3achygo_tpu import compile_cache

    compile_cache.enable()
    sys.exit(main())
