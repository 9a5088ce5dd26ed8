"""RL loop binary: python -m p3achygo_tpu.rl --config config/<run>.json.

Replaces `python -m python.rl_loop.train_sp_eval` (train_sp_eval.py:145).

--role splits the combined loop into the reference's distributed worker
deployment over a store bus (--store <dir|gs://...>):
  --role actor    selfplay worker (cc/selfplay/main.cc + sp_loop.py)
  --role learner  trainer/gater (train_sp_eval.py minus sp_loop)
  --role both     single-process combined loop (default)
"""
from __future__ import annotations

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--run-dir", default="runs/local")
    ap.add_argument("--gens", type=int, default=0,
                    help="override num_generations")
    ap.add_argument("--sgf-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true",
                    help="start fresh even if run-dir has resume state")
    ap.add_argument("--role", choices=("both", "actor", "learner"),
                    default="both")
    ap.add_argument("--store", default="",
                    help="store bus path or gs:// url (actor/learner)")
    ap.add_argument("--worker-id", default="w0")
    args = ap.parse_args()

    from p3achygo_tpu import compile_cache

    compile_cache.enable(min_compile_secs=5)

    from p3achygo_tpu.rl.config import parse
    from p3achygo_tpu.rl.loop import GenerationLoop

    cfg = parse(args.config)
    gens = args.gens or cfg.num_generations

    if args.role != "both":
        if not args.store:
            ap.error("--role actor/learner requires --store")
        from p3achygo_tpu.data.store import make_store, most_recent_model
        from p3achygo_tpu.rl.workers import Learner, SelfplayActor

        store = make_store(args.store)
        if args.role == "actor":
            actor = SelfplayActor(cfg, store, worker_id=args.worker_id,
                                  scratch_dir=args.run_dir, seed=args.seed)
            while True:
                swapped = actor.sync_model()
                if actor.model_gen >= gens:
                    return
                if actor.model_gen < 0:
                    time.sleep(1.0)  # no golden published yet
                    continue
                name = actor.play_and_publish(cfg.games_per_gen)
                print(json.dumps({"actor_gen": actor.model_gen,
                                  "chunk": name,
                                  "model_swapped": swapped}), flush=True)
        else:
            learner = Learner(cfg, store, run_dir=args.run_dir,
                              seed=args.seed)
            if most_recent_model(store) < 0:
                learner.publish_golden()  # seed the bus with gen 0
            while learner.loop.gen < gens:
                need = cfg.games_per_gen * 60  # ~examples per gen
                learner.wait_for_examples(need, timeout_s=3600.0)
                info = learner.train_generation()
                print(json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in info.items()}), flush=True)
            return

    loop = GenerationLoop(cfg, root_dir=args.run_dir, seed=args.seed)
    # Elastic recovery (train_sp_eval.py:213-215 + fs_utils.py:25-65): a
    # restarted process picks the run up from the last completed generation.
    if not args.no_resume and loop.try_resume():
        print(json.dumps({"resumed_at_gen": loop.gen}), flush=True)
    if args.sgf_dir:
        loop.sgf_dir = args.sgf_dir
    while loop.gen < gens:
        t0 = time.time()
        info = loop.run_generation()
        info["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)


if __name__ == "__main__":
    main()
