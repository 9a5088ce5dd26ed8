"""GTP binary: python -m p3achygo_tpu.gtp --model <ckpt> [--config tiny]."""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default="",
                    help="checkpoint directory (train/checkpoint.py)")
    ap.add_argument("--model", default="b12c128btl3")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()

    from p3achygo_tpu import compile_cache

    compile_cache.enable()
    from p3achygo_tpu.gtp.service import GtpConfig, GtpService, run_stdin_loop
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
    from p3achygo_tpu.models import build_model, get_config, init_params

    model = build_model(get_config(args.model), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    if args.checkpoint:
        from p3achygo_tpu.train.checkpoint import restore_checkpoint

        restored = restore_checkpoint(args.checkpoint, {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"],
        })
        variables = {"params": restored["params"],
                     "batch_stats": restored["batch_stats"]}
    eval_fn = make_eval_fn(model, variables)
    cfg = GtpConfig(search=SearchParams(n=args.n, k=args.k, noise_scale=0.0))
    run_stdin_loop(GtpService(eval_fn, cfg))


if __name__ == "__main__":
    main()
