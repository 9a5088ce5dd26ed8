"""Decoupled actor/learner workers over the artifact store bus.

Mirrors the reference's distributed RL deployment: selfplay workers
(cc/selfplay/main.cc) and the trainer (python/rl_loop/train_sp_eval.py)
run as separate processes/machines that only exchange artifacts through
GCS — models flow trainer -> workers, chunks flow workers -> trainer
(train_sp_eval.py:100-230, sp_loop.py:60-140, fs_utils.py). Here the bus
is a `data/store.py` Store (local dir / NFS / GCS), artifacts keep the
reference's formats (model_%04d checkpoints, gen..._.tfrecord.zz chunks,
`.done` markers), and each worker wraps a GenerationLoop:

- `SelfplayActor` polls the bus for a newer golden model, hot-swaps its
  traced weights, plays games, and publishes chunks.
- `Learner` ingests newly-done chunks into its replay, trains + gates a
  candidate (GenerationLoop.train_and_gate — the cand is published to
  model_cands/ BEFORE eval, train_sp_eval.py:213-215), and publishes the
  resulting golden to models/.

Deployment: one actor process per GPU saturates it with the lockstep
batch; scale-out = more actor processes against the same bus. The
learner is a separate process on its own GPU, so training and selfplay
never contend for a card (a JAX process reserves most of a card's memory
when it starts, so two processes cannot share one).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional

from p3achygo_tpu.data.export import read_game_chunk, write_game_chunk
from p3achygo_tpu.data.store import (
    SP_CHUNKS_DIR,
    list_done_chunks,
    model_name,
    most_recent_model,
)
from p3achygo_tpu.rl.config import RunConfig
from p3achygo_tpu.rl.loop import GenerationLoop
from p3achygo_tpu.train.checkpoint import restore_checkpoint, save_named


class SelfplayActor:
    """Selfplay worker: pull golden weights from the bus, play, push
    chunks (sp_loop.py loop + nn/engine model reload semantics)."""

    def __init__(self, cfg: RunConfig, store, worker_id: str = "w0",
                 scratch_dir: Optional[str] = None, seed: int = 0):
        self.cfg = cfg
        self.store = store
        self.worker_id = worker_id
        self.scratch = scratch_dir or tempfile.mkdtemp(prefix="actor_")
        self.loop = GenerationLoop(cfg, root_dir=self.scratch, seed=seed)
        self.model_gen = -1
        self._pending: List = []
        self._batch_id = 0
        self.loop.game_sink = self._pending.append

    def sync_model(self) -> bool:
        """Adopt the newest published golden model; True if swapped.
        Weights are traced jit arguments, so no recompile happens."""
        latest = most_recent_model(self.store)
        if latest <= self.model_gen:
            return False
        local = os.path.join(self.scratch, f"pull_model_{latest:04d}")
        src = self.store.local_path(model_name(latest))
        if src is None or not os.path.isdir(src):
            self.store.get(model_name(latest), local)
            src = local
        tpl = {"params": self.loop.golden["params"],
               "batch_stats": self.loop.golden["batch_stats"]}
        state = restore_checkpoint(src, tpl)
        self.loop.golden = {"params": state["params"],
                            "batch_stats": state["batch_stats"]}
        old_gen, self.model_gen = self.model_gen, latest
        self.loop.gen = latest  # n/k growth follows the published gen
        if old_gen >= 0:
            self.loop._sp_steps = None  # n/k may have changed with gen
        return True

    def play_and_publish(self, num_games: int) -> str:
        """Play `num_games`, publish ONE chunk (+ .done) to the bus."""
        self._pending.clear()
        self.loop.selfplay_games(num_games)
        name = None
        if self._pending:
            out_dir = os.path.join(self.scratch, "chunks")
            path = write_game_chunk(out_dir, list(self._pending),
                                    gen=max(self.model_gen, 0),
                                    batch_id=self._batch_id,
                                    worker_id=self.worker_id)
            name = f"{SP_CHUNKS_DIR}/{os.path.basename(path)}"
            self.store.put(path, name, done=True)
            self._batch_id += 1
            self._pending.clear()
        return name or ""

    def run(self, iterations: int, games_per_iter: int,
            poll_s: float = 0.0):
        """sp_loop.py:60-140 main loop: sync -> play -> publish."""
        for _ in range(iterations):
            self.sync_model()
            self.play_and_publish(games_per_iter)
            if poll_s:
                time.sleep(poll_s)


class Learner:
    """Trainer worker: ingest chunks from the bus, train + gate, publish
    goldens (train_sp_eval.py:100-230 with the store as the file bus)."""

    def __init__(self, cfg: RunConfig, store,
                 run_dir: Optional[str] = None, seed: int = 0):
        self.cfg = cfg
        self.store = store
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="learner_")
        self.loop = GenerationLoop(cfg, root_dir=self.run_dir, seed=seed)
        self._seen_chunks: set = set()

    def publish_golden(self):
        """Publish the current golden as models/model_%04d (+ .done)."""
        gen = self.loop.gen
        local = os.path.join(self.run_dir, f"pub_model_{gen:04d}")
        save_named(os.path.dirname(local), os.path.basename(local), {
            "params": self.loop.golden["params"],
            "batch_stats": self.loop.golden["batch_stats"],
        })
        self.store.put(local, model_name(gen), done=True)

    def ingest_new_chunks(self) -> int:
        """Pull newly-done selfplay chunks into the replay; returns number
        of examples ingested (tf_record_watcher + shuffle.py poll)."""
        total = 0
        for name in list_done_chunks(self.store, SP_CHUNKS_DIR):
            key = f"{SP_CHUNKS_DIR}/{name}"
            if name in self._seen_chunks:
                continue
            src = self.store.local_path(key)
            if src is None or not os.path.exists(src):
                src = self.store.get(
                    key, os.path.join(self.run_dir, "in_chunks", name))
            ex = read_game_chunk(src)
            if len(ex):
                self.loop.replay.add_game(ex)
                total += len(ex)
            self._seen_chunks.add(name)
        return total

    def wait_for_examples(self, min_examples: int, timeout_s: float = 300.0,
                          poll_s: float = 0.5) -> int:
        got = self.ingest_new_chunks()
        deadline = time.time() + timeout_s
        while len(self.loop.replay) < min_examples \
                and time.time() < deadline:
            time.sleep(poll_s)
            got += self.ingest_new_chunks()
        return got

    def train_generation(self, eval_gating: bool = True) -> dict:
        """One trainer generation over bus-fed data; publishes the golden
        (candidate-first inside train_and_gate)."""
        out = self.loop.train_and_gate(eval_gating=eval_gating)
        self.publish_golden()
        return out
