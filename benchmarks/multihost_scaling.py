"""Multi-process env-steps/s scaling measurement on the CPU mesh.

SURVEY §2.13 criterion: ">=80% env-steps/s scaling efficiency 1→N
hosts". This harness
measures the MECHANISM on CPU: the FULL tiered selfplay step (per-board
playout-cap tiers, tree reuse, grouped visits) runs as one SPMD program
over a jax.distributed cluster of {1, 2, 4} processes x 2 virtual devices,
with the production host-local harvest path (`local_shards` ->
finalize_game -> ReplayBuffer ingest) and finished-board recycling
exercised at the real cadence.

Round-4 rework (VERDICT r3 item 5): the round-3 harness had a noisy 1p
denominator (single trial, ±10%) and only N=2. Now:
  - CORE-FAIR pairs: every process in a comparison gets the same core
    share via taskset (2-core share for the 1→2 pair; 1-core share for
    the 1→2→4 series), so adding a process adds compute like adding a
    host would.
  - ≥5 trials for 1p baselines, 3 for multi-proc, medians reported.
  - DECOMPOSITION: each run times (a) the pure SPMD step loop with NO
    host work and (b) the full loop with harvest+recycle, separating the
    collective/coordination cost (present on real pods) from host-python
    harvest cost (which on a real pod runs on per-host CPUs that do not
    also execute the XLA program — on this CPU mesh it steals the same
    cores, a measurement artifact).
  - workers share the persistent CPU compile cache (trial 2+ skip
    compiles).

Weak scaling: each process owns B_LOCAL boards; ideal = rate(N) scales
linearly in N. Efficiency(N) = rate(Np) / (N * rate(1p, same core share)).

Usage: PYTHONPATH= JAX_PLATFORMS=cpu python benchmarks/multihost_scaling.py
Writes MULTIHOST.md at the repo root.
"""
from __future__ import annotations

import os
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B_LOCAL = 32
WARMUP_PLIES = 4
TIMED_PLIES = 24
HARVEST_EVERY = 8

_WORKER = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
pid = int(sys.argv[1]); port = sys.argv[2]; nproc = int(sys.argv[3])
B_LOCAL = int(sys.argv[4]); WARMUP = int(sys.argv[5]); TIMED = int(sys.argv[6])
HARVEST_EVERY = int(sys.argv[7]); CACHE = sys.argv[8]

import jax
# Persistent-cache coordination is POISON in multi-process clusters here:
# a SHARED cache dir makes the workers' Gloo context init reliably die
# (one side's GetKeyValue times out at 30 s / the peer's TCP pair connect
# times out; bisected round 4 — mixed cache hit/miss skews the processes
# past Gloo's 30 s connect window, and concurrent writes race). Round-5
# fix: a PER-PROCESS cache dir — no cross-process sharing or races, all
# workers see identical hit/miss timing, and trial 2+ still skips every
# compile (each pid re-reads its own dir across trials).
if CACHE != "none" and not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    cache_dir = CACHE if nproc == 1 else f"{CACHE}_p{pid}of{nproc}"
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

from p3achygo_tpu.parallel.distributed import (
    global_mesh, host_local_to_global, init_multihost, local_shards,
    replicate)
init_multihost(f"localhost:{port}", num_processes=nproc, process_id=pid,
               local_device_count=2)

import jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
assert len(jax.local_devices()) == 2

from p3achygo_tpu.game.board import new_state
from p3achygo_tpu.game.scoring import score as score_board
from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu.mcts.tree import make_tree
from p3achygo_tpu.models import build_model, get_config, init_params
from p3achygo_tpu.selfplay.loop import (
    SelfplayConfig, finished_mask, make_aux, make_game_buffer,
    reset_finished, selfplay_step_tiered)
from p3achygo_tpu.selfplay.records import finalize_game
from p3achygo_tpu.data.replay import ReplayBuffer

mesh = global_mesh(model_parallel=1)
B = B_LOCAL * nproc
RCAP = 16
cfg = SelfplayConfig(batch_size=B, max_game_len=16,
                     tier_groups=len(jax.devices()))
p_sel = SearchParams(n=16, k=4, max_depth=12, visit_group=2)
p_fast = SearchParams(n=8, k=2, max_depth=12, visit_group=2)
model = build_model(get_config("tiny"), dtype=jnp.float32)
variables = init_params(model, jax.random.PRNGKey(0))
eval_fn = make_eval_fn(model, variables)

with mesh:
    variables = replicate(variables, mesh)
    eval_fn = make_eval_fn(model, variables)

    # Host-local slabs -> global batch-sharded arrays.
    loc = jax.vmap(lambda _: new_state(cfg.komi))(jnp.arange(B_LOCAL))
    states = host_local_to_global(
        jax.tree_util.tree_map(np.asarray, loc), mesh)
    buf = host_local_to_global(jax.tree_util.tree_map(
        np.asarray, make_game_buffer(B_LOCAL, cfg.max_game_len)), mesh)
    aux_l = make_aux(jax.random.PRNGKey(100 + pid), B_LOCAL)
    aux = host_local_to_global(
        jax.tree_util.tree_map(np.asarray, aux_l), mesh)
    tree = host_local_to_global(jax.tree_util.tree_map(
        np.asarray, make_tree(B_LOCAL, RCAP)), mesh)

    @jax.jit
    def sp_step(states, buf, aux, tree, key):
        return selfplay_step_tiered(states, buf, aux, key, eval_fn, p_sel,
                                    p_fast, cfg, reuse_tree=tree,
                                    reuse_capacity=RCAP)

    @jax.jit
    def reset_fn(states, buf, aux, tree, done, key):
        return reset_finished(states, buf, aux, done, cfg.komi, key,
                              max_raw_policy_moves=0, reuse_tree=tree)

    # Gloo's first-collective rendezvous has a HARD-CODED 30 s window
    # (GetKeyValue timeout in XLA's gloo kv-store); single-core workers
    # skew past it on startup/tracing/compile (round-5 bisect: warm
    # caches alone did not fix 2p@1c). Eliminate the skew instead of
    # racing it: (1) AOT lower+compile every SPMD program BEFORE any
    # execution — this populates the per-process persistent cache, so the
    # later jit calls re-trace cheaply and hit it; (2) meet at a pure
    # KV-store barrier (10 min window, no Gloo); (3) establish the Gloo
    # clique with a trivial all-reduce executed in lockstep. The big
    # programs then reuse the established context.
    key0 = jax.device_put(jax.random.PRNGKey(7), NamedSharding(mesh, P()))
    done0 = finished_mask(states, cfg)  # per-board ops: no collectives
    sp_step.lower(states, buf, aux, tree, key0).compile()
    reset_fn.lower(states, buf, aux, tree, done0, key0).compile()
    from jax._src import distributed as _dist
    if _dist.global_state.client is not None:
        _dist.global_state.client.wait_at_barrier("aot_compile_done",
                                                  600_000)
    jax.block_until_ready(
        jax.jit(lambda a: jnp.sum(a.astype(jnp.float32)))(done0))

    score_fn = jax.jit(jax.vmap(score_board))
    replay = ReplayBuffer(capacity=1 << 16, seed=pid)
    # Replicated key: every process MUST pass identical step keys or the
    # SPMD programs diverge (the step splits per-board keys internally;
    # shaped draws shard via partitionable threefry).
    key = jax.device_put(jax.random.PRNGKey(7), NamedSharding(mesh, P()))

    def harvest(states, buf):
        done_g = finished_mask(states, cfg)
        done = local_shards(done_g)
        if not done.any():
            return done_g, 0
        idx = np.flatnonzero(done)
        bs, ws, own = score_fn(states)
        sub = jax.tree_util.tree_map(local_shards, (buf, states))
        buf_np, st_np = sub
        n = 0
        for b in idx:
            L = min(int(st_np.move_count[b]), cfg.max_game_len)
            ex = finalize_game(
                stones=buf_np.stones[b], last_moves=buf_np.last_moves[b],
                to_move=buf_np.to_move[b], pi=buf_np.pi[b],
                move=buf_np.move[b],
                root_q_outcome=buf_np.root_q_outcome[b],
                root_score=buf_np.root_score[b], kld=buf_np.kld[b],
                trainable=buf_np.trainable[b],
                mcts_value_dist=buf_np.mcts_value_dist[b],
                num_moves=L,
                black_score=float(local_shards(bs)[b]),
                white_score=float(local_shards(ws)[b]),
                ownership=np.asarray(local_shards(own)[b]),
                komi=float(st_np.komi[b]))
            if ex is not None:
                replay.add_game(ex)
                n += 1
        return done_g, n

    def play(nplies, states, buf, aux, tree, key, with_harvest=True):
        for i in range(nplies):
            states, buf, aux, tree, key = sp_step(states, buf, aux, tree, key)
            if with_harvest and (i + 1) % HARVEST_EVERY == 0:
                done_g, _ = harvest(states, buf)
                key, kr = jax.random.split(key)
                states, buf, aux, tree = reset_fn(states, buf, aux, tree,
                                                  done_g, kr)
        jax.block_until_ready(states.stones)
        return states, buf, aux, tree, key

    # warmup (compiles both programs)
    st = play(WARMUP, states, buf, aux, tree, key)
    _ = harvest(st[0], st[1])

    # (a) pure SPMD step loop, no host work
    t0 = time.time()
    st = play(TIMED, *st, with_harvest=False)
    dt_step = time.time() - t0

    # (b) full loop with harvest + recycle
    t0 = time.time()
    st = play(TIMED, *st, with_harvest=True)
    dt_full = time.time() - t0

    env_steps = B * TIMED
    print(f"SCALING_OK pid={pid} nproc={nproc} "
          f"step_only_eps={env_steps / dt_step:.2f} "
          f"full_eps={env_steps / dt_full:.2f} "
          f"replay_examples={replay.total_added} games={replay.games_added}",
          flush=True)
"""


def run_cluster(nproc: int, cores_per_proc: int) -> dict:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = "/tmp/mh_scaling_worker.py"
    with open(worker, "w") as f:
        f.write(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("GLOO_SOCKET_IFNAME", None)
    cache = os.path.join(REPO, ".jax_cache_cpu")
    procs = [
        subprocess.Popen(
            ["taskset", "-c",
             f"{i * cores_per_proc}-{(i + 1) * cores_per_proc - 1}",
             sys.executable, worker, str(i), str(port), str(nproc),
             str(B_LOCAL), str(WARMUP_PLIES), str(TIMED_PLIES),
             str(HARVEST_EVERY), cache],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=3600)
        outs.append(out)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise RuntimeError(f"worker failed:\n{out[-4000:]}")
    stats = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SCALING_OK"):
                kv = dict(x.split("=") for x in line.split()[1:])
                stats[int(kv["pid"])] = kv
    assert len(stats) == nproc, stats
    return stats


def measure(nproc: int, cores_per_proc: int, trials: int) -> dict:
    step, full, games, examples = [], [], 0, 0
    for t in range(trials):
        try:
            stats = run_cluster(nproc, cores_per_proc)
        except RuntimeError as e:
            # First multi-proc attempt can die in Gloo context init: cold
            # compiles on taskset'd cores diverge past the 30 s key-value
            # timeout. The failed attempt still populates the persistent
            # compile cache, so one retry starts the workers synchronized.
            print(f"  nproc={nproc} trial {t} failed "
                  f"({str(e).splitlines()[0][:80]}...); retrying once",
                  flush=True)
            stats = run_cluster(nproc, cores_per_proc)
        step.append(float(stats[0]["step_only_eps"]))
        full.append(float(stats[0]["full_eps"]))
        games = sum(int(v["games"]) for v in stats.values())
        examples = sum(int(v["replay_examples"]) for v in stats.values())
        print(f"  nproc={nproc} cores/proc={cores_per_proc} trial {t}: "
              f"step_only={step[-1]:.1f} full={full[-1]:.1f} eps", flush=True)
    return dict(step=statistics.median(step), full=statistics.median(full),
                step_all=step, full_all=full, games=games, examples=examples)


def main():
    ncores = os.cpu_count() or 4
    results = {}
    # 2-core-share pair: 1p vs 2p (uses all cores at N=2 on a 4-core box)
    results[(1, 2)] = measure(1, 2, trials=5)
    results[(2, 2)] = measure(2, 2, trials=3)
    # 1-core-share series: 1p vs 2p vs 4p
    results[(1, 1)] = measure(1, 1, trials=5)
    results[(2, 1)] = measure(2, 1, trials=3)
    if ncores >= 4:
        results[(4, 1)] = measure(4, 1, trials=3)

    def eff(n, share, kind):
        return results[(n, share)][kind] / (n * results[(1, share)][kind])

    lines = [
        "# Multi-host scaling measurement (CPU mesh)",
        "",
        "SURVEY §2.13 criterion: >=80% env-steps/s scaling efficiency",
        "1→N hosts. Measured on the CPU mesh (the only multi-process",
        "environment available): jax.distributed cluster of N processes x 2",
        "virtual devices, FULL production selfplay path (tiered search",
        "n=16/k=4 + n=8/k=2, visit_group=2, tree reuse cap 16, host-local",
        "harvest -> finalize_game -> ReplayBuffer, recycling every "
        f"{HARVEST_EVERY} plies).",
        f"Weak scaling, {B_LOCAL} boards/process. CORE-FAIR: taskset gives",
        "every process in a comparison the same core share; 1p baselines are",
        "5-trial medians (round-3's single-trial denominator was ±10%).",
        "",
        "`step-only` times the pure SPMD program (what a real cluster",
        "executes); `full` adds the host-python harvest, which on a real pod",
        "runs on per-host CPUs that do NOT also execute the XLA program —",
        "here it steals the same cores, so step-only is the mechanism number.",
        "",
        "| procs | cores/proc | step-only eps | eff | full eps | eff |",
        "|---|---|---|---|---|---|",
    ]
    for (n, share), r in sorted(results.items(), key=lambda kv: (kv[0][1],
                                                                 kv[0][0])):
        es = f"{eff(n, share, 'step'):.1%}" if n > 1 else "—"
        ef = f"{eff(n, share, 'full'):.1%}" if n > 1 else "—"
        lines.append(f"| {n} | {share} | {r['step']:.1f} | {es} | "
                     f"{r['full']:.1f} | {ef} |")
    lines += [
        "",
        f"Trials (step-only): " + "; ".join(
            f"{n}p@{s}c={['%.1f' % v for v in r['step_all']]}"
            for (n, s), r in sorted(results.items())),
        "",
        f"Generated by benchmarks/multihost_scaling.py "
        f"({time.strftime('%Y-%m-%d')}).",
    ]
    with open(os.path.join(REPO, "MULTIHOST.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print("wrote MULTIHOST.md")


if __name__ == "__main__":
    main()
