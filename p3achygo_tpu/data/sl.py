"""SL dataset pipeline: SGF games -> training examples.

Replaces cc/data/ (coordinator/worker SGF->TFRecord builder) and
python/datasets/common/example_generator.py: replays each SGF's main line
through the rules engine and emits one example per position with a one-hot
policy target of the played move, the game result as outcome/score targets,
and zeroed RL-only targets (SL loss coefficients zero them out,
loss_coeffs.py SLCoeffs).
"""
from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional

import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import (
    BLACK,
    NUM_LAST_MOVES,
    NUM_LOCS,
    NUM_MOVES,
    WHITE,
)
from p3achygo_tpu.game.board import new_state, step
from p3achygo_tpu.selfplay.records import GameExamples
from p3achygo_tpu.sgf import extract_moves, game_info, parse_sgf


def _result_to_z_margin(result: str):
    """'B+3.5' -> (winner, margin); resign/time -> margin None."""
    m = re.match(r"^([BW])\+(.*)$", result.strip(), re.IGNORECASE)
    if not m:
        return 0, None
    winner = BLACK if m.group(1).upper() == "B" else WHITE
    rest = m.group(2).strip().upper()
    if rest in ("R", "RESIGN", "T", "TIME", "F", ""):
        return winner, None
    try:
        return winner, float(rest)
    except ValueError:
        return winner, None


def sgf_to_examples(text: str, max_moves: int = 1000
                    ) -> Optional[GameExamples]:
    """One SGF -> per-move SL examples (None if unusable)."""
    root = parse_sgf(text)
    info = game_info(root)
    if info["board_size"] != 19:
        return None
    moves = extract_moves(root)[:max_moves]
    if len(moves) < 2:
        return None
    winner, margin = _result_to_z_margin(info["result"])
    if winner == 0:
        return None
    komi = float(info["komi"])

    M = len(moves)
    stones = np.zeros((M, NUM_LOCS), np.int8)
    last_moves = np.zeros((M, NUM_LAST_MOVES), np.int16)
    colors = np.zeros((M,), np.int8)
    pi = np.zeros((M, NUM_MOVES), np.float32)
    pi_aux = np.full((M,), NUM_LOCS, np.int16)

    st = new_state(komi)
    for t, (color, action) in enumerate(moves):
        if int(st.to_move) != color:
            st = st._replace(to_move=jnp.int8(color))
        stones[t] = np.asarray(st.stones)
        last_moves[t] = np.asarray(st.last_moves).astype(np.int16)
        colors[t] = color
        pi[t, action] = 1.0
        if t + 1 < M:
            pi_aux[t] = moves[t + 1][1]
        st, status = step(st, jnp.int32(action))
        if int(status) != 0:
            return None  # corrupt game record

    z = np.where(colors == winner, 1.0, -1.0).astype(np.float32)
    sm = np.zeros((M,), np.float32)
    if margin is not None:
        black_margin = margin if winner == BLACK else -margin
        sm = (black_margin * colors).astype(np.float32)

    return GameExamples(
        stones=stones,
        last_moves=last_moves,
        color=colors,
        komi=np.full((M,), komi, np.float32),
        pi=pi,
        pi_aux=pi_aux,
        pi_aux_dist=np.zeros((M, NUM_MOVES), np.float32),
        has_pi_aux_dist=np.zeros((M,), bool),
        own=np.zeros((M, NUM_LOCS), np.int8),
        score_margin=sm,
        z=z,
        q6=np.zeros((M,), np.float32),
        q16=np.zeros((M,), np.float32),
        q50=np.zeros((M,), np.float32),
        q6_score=np.zeros((M,), np.float32),
        q16_score=np.zeros((M,), np.float32),
        q50_score=np.zeros((M,), np.float32),
        weight=np.ones((M,), np.float32),
        mcts_value_dist=np.zeros((M, 51), np.uint16),
    )


def iter_sgf_dir(path: str) -> Iterator[GameExamples]:
    """Stream SL examples from every .sgf under `path` (Coordinator/Worker
    parity, cc/data/coordinator.h:11-48, single-process)."""
    for dirpath, _, files in os.walk(path):
        for name in sorted(files):
            if not name.endswith(".sgf"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                try:
                    ex = sgf_to_examples(f.read())
                except (ValueError, IndexError):
                    continue
            if ex is not None:
                yield ex


def build_sl_replay(sgf_dir: str, replay, limit_games: Optional[int] = None
                    ) -> int:
    """Fill a ReplayBuffer from an SGF corpus; returns #games ingested."""
    count = 0
    for ex in iter_sgf_dir(sgf_dir):
        replay.add_game(ex)
        count += 1
        if limit_games and count >= limit_games:
            break
    return count


# ---------------------------------------------------------------------------
# Multi-worker shard builder (Coordinator/Worker, cc/data/coordinator.h:11-48
# + worker.cc): the reference's coordinator delegates SGF files to N worker
# threads which emit TFRecord shards and report completions. Here: a
# spawn-context process pool — each worker replays its file slice
# through the (CPU) rules engine and writes `sl_shard_%04d_w%d.tfrecord.zz`
# shards via the streaming native codec; the parent writes a `.done` marker
# (the reference's partial-write convention, data/filename_format.h:14-15)
# with the aggregate counts.
# ---------------------------------------------------------------------------

def _sl_worker_init():
    # Workers stay off the card: a JAX process reserves most of a GPU's
    # memory when it starts, so the parent's card must not be shared.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("PYTHONSTARTUP", None)


def _sl_worker(args):
    worker_id, files, out_dir, examples_per_shard = args
    from p3achygo_tpu.data.export import examples_to_records
    from p3achygo_tpu.data.tfrecord import write_records

    shard, pending, shards = 0, [], []
    games = examples = errors = 0

    def flush():
        nonlocal shard, pending
        if not pending:
            return
        name = f"sl_shard_{shard:04d}_w{worker_id}.tfrecord.zz"
        write_records(os.path.join(out_dir, name), pending, zlib_level=6)
        shards.append(name)
        shard += 1
        pending = []

    for path in files:
        try:
            with open(path) as f:
                ex = sgf_to_examples(f.read())
        except (ValueError, IndexError, OSError):
            errors += 1
            continue
        if ex is None:
            errors += 1
            continue
        recs = examples_to_records(ex)
        games += 1
        examples += len(recs)
        pending.extend(recs)
        if len(pending) >= examples_per_shard:
            flush()
    flush()
    return dict(worker=worker_id, games=games, examples=examples,
                errors=errors, shards=shards)


def build_sl_shards(sgf_dir: str, out_dir: str, num_workers: int = 4,
                    examples_per_shard: int = 4096) -> dict:
    """Fan SGF->example work over `num_workers` processes; write TFRecord
    shards + a `.done` marker. Returns the aggregate report."""
    import json
    import multiprocessing as mp

    files = []
    for dirpath, _, names in os.walk(sgf_dir):
        files.extend(os.path.join(dirpath, n) for n in sorted(names)
                     if n.endswith(".sgf"))
    os.makedirs(out_dir, exist_ok=True)
    slices = [files[i::num_workers] for i in range(num_workers)]
    work = [(i, s, out_dir, examples_per_shard)
            for i, s in enumerate(slices) if s]
    if not work:
        reports = []
    elif len(work) == 1:
        reports = [_sl_worker(work[0])]
    else:
        # Force CPU in the parent env BEFORE spawning: spawn workers import
        # this module (and its game/board jnp tables) to unpickle the worker
        # fn, which initializes the JAX backend before the Pool initializer
        # runs — on a GPU host each worker would reserve most of the card's
        # memory, and the second process to start fails for want of it.
        # Children inherit the environment at exec, so setting it
        # here covers module-import time; _sl_worker_init stays as
        # belt-and-suspenders.
        prev = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            ctx = mp.get_context("spawn")
            with ctx.Pool(len(work), initializer=_sl_worker_init) as pool:
                reports = pool.map(_sl_worker, work)
        finally:
            if prev is None:
                os.environ.pop("JAX_PLATFORMS", None)
            else:
                os.environ["JAX_PLATFORMS"] = prev
    agg = dict(
        files=len(files),
        games=sum(r["games"] for r in reports),
        examples=sum(r["examples"] for r in reports),
        errors=sum(r["errors"] for r in reports),
        shards=sorted(n for r in reports for n in r["shards"]),
        workers=len(work),
    )
    with open(os.path.join(out_dir, "sl_shards.done"), "w") as f:
        json.dump(agg, f)
    return agg
