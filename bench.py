"""Benchmark: self-play moves/s/chip on b12c128 @ 19x19 (BASELINE.json).

Runs the full vectorized self-play step with the REFERENCE workload mix
(selfplay/main.cc:40-47 defaults: 25% of moves selected-tier n=128 k=8,
75% fast-tier n=32 k=5, per-board playout-cap randomization) with
in-graph b12c128btl3 bf16 inference, tree reuse, superko guard, board
step and record writes — measured at STEADY STATE: 100 plies are played
before timing so trees, reuse carries and game phases reflect mid-game
self-play rather than the tiny-tree opening.

Finished boards are recycled with fresh games at the production harvest
cadence (rl/loop.py harvests + reset_finished every 16 plies): without
recycling, the active-board count decays through the measurement window
while the lockstep step cost stays full-width, so moves/s would measure
the game-length distribution of the random-init net instead of sustained
throughput. Reset cost is inside the timed region.

Reference anchor: ~70 min/generation at 5,000 games/gen on 1x A100 + 30
vCPU => ~250-400 self-play moves/s system-wide (BASELINE.md,
journal.md:188), with the same 25/75 tier mix. vs_baseline uses the 325
moves/s midpoint.

Prints ONE JSON line, naming the device it ran on. Needs a GPU: with
none, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp

from p3achygo_tpu import compile_cache

BASELINE_MOVES_PER_SEC = 325.0
WARMUP_PLIES = int(os.environ.get("BENCH_WARMUP_PLIES", "100"))
TIMED_PLIES = int(os.environ.get("BENCH_TIMED_PLIES", "32"))
RESET_EVERY = 16  # production harvest cadence (rl/loop.py:297)
# Noise floor: repeat the timed window TRIALS times on the same warmed
# state and report the median; the min/max spread goes in the JSON so
# deltas between runs are interpretable.
TRIALS = int(os.environ.get("BENCH_TRIALS", "5"))
# Serving graph: BN-folded, head-pruned forward (p3achygo_tpu/nn/serve.py).
SERVE_FOLD = os.environ.get("BENCH_SERVE_FOLD", "1") == "1"


def require_gpu():
    """Refuse to measure anywhere but on a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"needs a GPU; JAX found only the {backend!r} backend")


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def gpu_name_and_power() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them
    (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def build_selfplay(batch: int = 1024, visit_group: int = 4,
                   config: str = "b12c128btl3",
                   seed: int = 0) -> SimpleNamespace:
    """The benchmark's self-play program: b12c128btl3 bf16, 25% of moves
    at n=128/k=8 and 75% at n=32/k=5, tree reuse, game recycling.

    Returns jitted `sp_step(states, buf, aux, tree, key)` and
    `recycle(states, buf, aux, tree, key)`, the self-play config, and
    `init(key)` -> the initial (states, buf, aux, tree, key) carry."""
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
    from p3achygo_tpu.mcts.tree import make_tree
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.selfplay.loop import (
        SelfplayConfig,
        finished_mask,
        make_aux,
        make_game_buffer,
        reset_finished,
        selfplay_step_tiered,
    )

    cfg = SelfplayConfig(batch_size=batch)
    # Grouped visits (SearchParams.visit_group): the production default.
    params_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                              visit_group=visit_group)
    params_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                               visit_group=visit_group)

    model = build_model(get_config(config), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(seed))
    eval_fn = make_eval_fn(model, variables, serve_fold=SERVE_FOLD)
    reuse_capacity = 64

    @jax.jit
    def sp_step(states, buf, aux, tree, key):
        return selfplay_step_tiered(
            states, buf, aux, key, eval_fn, params_sel, params_fast, cfg,
            reuse_tree=tree, reuse_capacity=reuse_capacity)

    @jax.jit
    def recycle(states, buf, aux, tree, key):
        # Fresh games only, raw-policy opening kept off (pure full-search
        # workload); records are dropped (the production loop harvests
        # them host-side at the same cadence).
        done = finished_mask(states, cfg)
        states, buf, aux, tree = reset_finished(
            states, buf, aux, done, cfg.komi, key,
            max_raw_policy_moves=0, reuse_tree=tree)
        return states, buf, aux, tree

    def init(key):
        states = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(batch))
        key, kaux = jax.random.split(key)
        aux = make_aux(kaux, batch)
        # Disable the raw-policy opening for a pure full-search benchmark.
        aux = aux._replace(raw_until=aux.raw_until * 0)
        return (states, make_game_buffer(batch, cfg.max_game_len), aux,
                make_tree(batch, reuse_capacity), key)

    return SimpleNamespace(sp_step=sp_step, recycle=recycle, init=init,
                           cfg=cfg, model=model, variables=variables)


def run_plies(sp, carry, plies: int, sp_step=None, recycle=None):
    """Play `plies` plies, recycling finished games every RESET_EVERY.
    Returns (carry, per-ply device counts of the active boards)."""
    from p3achygo_tpu.selfplay.loop import finished_mask

    sp_step = sp_step or sp.sp_step
    recycle = recycle or sp.recycle
    states, buf, aux, tree, key = carry
    active_counts = []
    for i in range(plies):
        active_counts.append(jnp.sum(~finished_mask(states, sp.cfg)))
        states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
        if (i + 1) % RESET_EVERY == 0:
            key, kr = jax.random.split(key)
            states, buf, aux, tree = recycle(states, buf, aux, tree, kr)
    jax.block_until_ready(states.stones)
    return (states, buf, aux, tree, key), active_counts


def main():
    require_gpu()
    compile_cache.enable(min_compile_secs=5)
    gpu = gpu_name_and_power()
    B = int(os.environ.get("BENCH_BATCH", "1024"))
    g = int(os.environ.get("BENCH_VISIT_GROUP", "4"))
    sp = build_selfplay(B, g)
    # Warmup/compile + play into the mid-game, recycling finished games at
    # the production cadence.
    carry, _ = run_plies(sp, sp.init(jax.random.PRNGKey(1)), WARMUP_PLIES)

    trial_rates = []
    for _ in range(TRIALS):
        t0 = time.time()
        carry, active_counts = run_plies(sp, carry, TIMED_PLIES)
        dt = time.time() - t0
        trial_rates.append(sum(int(c) for c in active_counts) / dt)

    trial_rates.sort()
    moves_per_sec = trial_rates[len(trial_rates) // 2]
    name, _, power = gpu.partition(",")
    print(json.dumps({
        "metric": "selfplay_moves_per_sec_per_chip_b12c128_refmix_steady",
        "value": round(moves_per_sec, 2),
        "unit": "moves/s/chip",
        "vs_baseline": round(moves_per_sec / BASELINE_MOVES_PER_SEC, 3),
        "trials": len(trial_rates),
        "spread": [round(trial_rates[0], 2), round(trial_rates[-1], 2)],
        "serve_fold": SERVE_FOLD,
        "device": device_record(),
        "gpu_name": name.strip(),
        "power_limit": power.strip(),
    }))


if __name__ == "__main__":
    main()
