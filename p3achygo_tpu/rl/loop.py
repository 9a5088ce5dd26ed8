"""Full RL generation loop (replaces python/rl_loop/train_sp_eval.py:145-487).

Per generation: self-play `games_per_gen` games with the *golden* weights
-> train the live model on the replay window -> SWA-average + BN refresh
-> cur-vs-cand eval against golden -> promote iff relative Elo > 0
(train_sp_eval.py:229-233) -> checkpoint model_%04d + live, append
elo_history.txt (train_sp_eval.py:234-238).

One process, one (or one mesh of) chip(s): the selfplay/shuffler/trainer
file relay collapses into in-memory hand-off.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.data.pipeline import prepare_batch
from p3achygo_tpu.data.replay import ReplayBuffer
from p3achygo_tpu.eval.harness import EvalConfig, EvalRunner
from p3achygo_tpu.game.board import new_state
from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu.models import LossCoeffs, build_model, get_config, init_params
from p3achygo_tpu.rl.config import (
    RunConfig,
    eval_games_for_gen,
    eval_n_for_gen,
    gumbel_params_for_gen,
)
from p3achygo_tpu.selfplay.loop import (
    SelfplayConfig,
    final_scores,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step_tiered,
)
from p3achygo_tpu.selfplay.move_sel import (
    calibration_from_dict,
    default_calibration,
)
from p3achygo_tpu.selfplay.fork import (
    ForkEvaluator,
    ForkManager,
    ForkParams,
    GameRecord,
)
from p3achygo_tpu.selfplay.records import finalize_game, game_to_sgf
from p3achygo_tpu.selfplay.reuse import (
    FMB_FORCE_FULL_SEARCH,
    FMB_SAMPLE,
    InitState,
    make_reuse_buffer,
)
from p3achygo_tpu.selfplay.stats import (
    MoveStatsBatch,
    compute_calibration,
    compute_sel_mult_base,
    write_calibration_file,
    write_stats_file,
)
from p3achygo_tpu.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_named,
)
from p3achygo_tpu.train.lr_schedule import lr_for_gen
from p3achygo_tpu.train.optimizer import conv_muon, sgd_nesterov
from p3achygo_tpu.train.step import (
    TrainState,
    create_train_state,
    make_train_step,
)
from p3achygo_tpu.train.swa import (
    SnapshotManager,
    make_bn_fwd,
    recompute_batch_stats,
    swa_average,
)
from p3achygo_tpu.train.val import batch_metrics


def make_optimizer(cfg: RunConfig):
    """The run's optimizer. LR is injected as an opt_state hyperparameter
    so the per-gen schedule (rl_loop/train.py:33-49) updates it without
    recompiling the train step or resetting momentum."""
    import optax

    lr0 = lr_for_gen(cfg, 0)
    if cfg.optimizer == "muon":
        return optax.inject_hyperparams(
            conv_muon, static_args=("nesterov", "ns_steps"))(
            learning_rate=lr0, weight_decay=cfg.muon_wd,
            wd_lr_exponent=cfg.wd_lr_exponent,
            wd_lr_max=cfg.wd_lr_max,
            adam_weight_decay=cfg.adam_wd)
    return optax.inject_hyperparams(sgd_nesterov)(learning_rate=lr0)


class GenerationLoop:
    def __init__(self, cfg: RunConfig, root_dir: str = "runs/local",
                 dtype=jnp.bfloat16, seed: int = 0):
        self.cfg = cfg
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.model = build_model(get_config(cfg.model_config), dtype=dtype)
        self.variables = init_params(self.model, jax.random.PRNGKey(seed))
        self.replay = ReplayBuffer(capacity=cfg.replay_capacity, seed=seed)
        # Held-out split for per-gen validation (dual validation,
        # rl_loop/train.py:183-198): val_game_frac of finished games land
        # here instead of the training replay.
        self.val_replay = ReplayBuffer(capacity=1 << 16, seed=seed + 3)
        self.key = jax.random.PRNGKey(seed + 1)

        tx = make_optimizer(cfg)
        self.tx = tx
        self.train_state = create_train_state(self.variables, tx)
        self._train_step = jax.jit(
            make_train_step(self.model, tx, LossCoeffs.rl()))
        self._prepare = jax.jit(partial(prepare_batch, augment=True))
        self._prepare_val = jax.jit(partial(prepare_batch, augment=False))
        self._score_fn = jax.jit(final_scores)
        from p3achygo_tpu.game.scoring import refresh_pass_alive

        # In-game pass-alive move bans: recompute Benson regions at the
        # reference's checkpoints (kComputePAMoveNums + >= 3 passes),
        # polled on a host cadence (scoring.refresh_pass_alive).
        self._pa_refresh = jax.jit(lambda s: refresh_pass_alive(s))
        self._bn_fwd = make_bn_fwd(self.model)

        @jax.jit
        def _val_fn(variables, planes, scalars, targets):
            from p3achygo_tpu.models.losses import compute_losses

            outputs = self.model.apply(variables, planes, scalars,
                                       train=False)
            losses = compute_losses(outputs, targets, LossCoeffs.rl())
            return {**losses, **batch_metrics(outputs, targets)}

        self._val_fn = _val_fn

        # Golden weights drive selfplay + are the eval incumbent.
        self.golden = {"params": self.train_state.params,
                       "batch_stats": self.train_state.batch_stats}
        self.gen = 0
        self.snapshots = SnapshotManager()

        B = cfg.selfplay_batch_size
        self.sp_cfg = SelfplayConfig(
            batch_size=B, max_game_len=cfg.selfplay_max_game_len,
            sel_mult_scale_factor=cfg.sel_mult_scale_factor)
        # sel_mult calibration (sp_loop.py:140-157): traced args of the
        # selfplay step, refreshed per generation from .stats files.
        self.calib = default_calibration()
        self.sel_mult_base = jnp.float32(cfg.sel_mult_base)
        self.stats_dir = os.path.join(root_dir, "stats")
        self._move_stats: list = []
        self.states = jax.vmap(lambda _: new_state(self.sp_cfg.komi))(
            jnp.arange(B))
        self.buf = make_game_buffer(B, self.sp_cfg.max_game_len)
        self.key, kaux = jax.random.split(self.key)
        self.aux = make_aux(kaux, B, self.sp_cfg.max_raw_policy_moves)
        self.reuse = make_reuse_buffer(cfg.reuse_buffer_type, seed=seed)
        # Fork manager (fork_manager.h): per-game fork plans, harvest-time
        # execution with batched NN rounds.
        self.fork: Optional[ForkManager] = None
        if cfg.fork_enabled:
            fp = ForkParams.for_reuse(cfg.use_seen_state_prob) \
                if cfg.use_seen_state_prob > 0 else ForkParams()
            if cfg.fork_regret_prob > 0:
                fp = dataclasses.replace(
                    fp, regret_prob=cfg.fork_regret_prob,
                    late_fork_prob=max(
                        fp.late_fork_prob - cfg.fork_regret_prob, 0.0))
            self.fork = ForkManager(
                fp, self.reuse, ForkEvaluator(model=self.model), seed=seed)
        self._fork_plans = [None] * B
        self._init_mv = np.zeros(B, np.int32)
        self._is_fresh = np.ones(B, bool)
        if self.fork is not None:
            self._fork_plans = [self.fork.new_plan(True) for _ in range(B)]
        from p3achygo_tpu.mcts.tree import make_tree
        from p3achygo_tpu.rl.config import gumbel_params_for_gen as _gp

        max_n = max(_gp(cfg, cfg.num_generations, True)[0],
                    _gp(cfg, cfg.num_generations, False)[0],
                    _gp(cfg, 0, True)[0])
        self.reuse_capacity = max_n + 2 if self.sp_cfg.tree_reuse else 0
        self.tree = (make_tree(B, self.reuse_capacity)
                     if self.sp_cfg.tree_reuse else None)
        # Value-bias cache (bias_cache.h; OFF by default like the
        # reference, selfplay/main.cc:58).
        if cfg.bias_cache_lambda > 0:
            from p3achygo_tpu.mcts.bias import make_bias_table

            self.bias = make_bias_table(B, 1024)
        else:
            self.bias = None
        self.sgf_dir: Optional[str] = None
        self._sp_steps = None
        self._np_rng = np.random.default_rng(seed + 2)
        # Optional tap on finalized games (actor mode exports them to the
        # store bus instead of only feeding the local replay; workers.py).
        self.game_sink = None

    # ---------------- selfplay ----------------
    def _bind_selfplay(self):
        """One jitted step with PER-BOARD playout-cap randomization: a
        random quarter of the batch runs the selected tier and the rest the
        fast tier, each as a compact sub-batch at its own width
        (selfplay_step_tiered; self_play_thread.cc:527-611).

        Golden weights are a TRACED argument so weight updates between
        generations never retrace/recompile the selfplay programs.
        """
        cfg = self.sp_cfg
        n_s, k_s = gumbel_params_for_gen(self.cfg, self.gen, selected=True)
        n_f, k_f = gumbel_params_for_gen(self.cfg, self.gen, selected=False)
        es = self.cfg.early_stopping_enabled
        vg = max(self.cfg.visit_group, 1)
        bl, ba = self.cfg.bias_cache_lambda, self.cfg.bias_cache_alpha
        tm = self.cfg.terminal_mode
        params_sel = SearchParams(n=n_s, k=k_s, noise_scale=1.0, max_depth=24,
                                  early_stopping=es, visit_group=vg,
                                  bias_lambda=bl, bias_alpha=ba,
                                  terminal_mode=tm)
        params_fast = SearchParams(n=n_f, k=k_f, noise_scale=1.0,
                                   max_depth=24, early_stopping=es,
                                   visit_group=vg, bias_lambda=bl,
                                   bias_alpha=ba, terminal_mode=tm)
        if self.tree is not None and self.bias is not None:
            @jax.jit
            def sp_step(states, buf, aux, tree, bias, key, golden, calib,
                        sel_base):
                eval_fn = make_eval_fn(self.model, golden)
                return selfplay_step_tiered(
                    states, buf, aux, key, eval_fn, params_sel, params_fast,
                    cfg, reuse_tree=tree,
                    reuse_capacity=self.reuse_capacity,
                    calib=calib, sel_mult_base=sel_base, bias_table=bias)
        elif self.tree is not None:
            @jax.jit
            def sp_step(states, buf, aux, tree, key, golden, calib,
                        sel_base):
                eval_fn = make_eval_fn(self.model, golden)
                return selfplay_step_tiered(
                    states, buf, aux, key, eval_fn, params_sel, params_fast,
                    cfg, reuse_tree=tree,
                    reuse_capacity=self.reuse_capacity,
                    calib=calib, sel_mult_base=sel_base)
        else:
            @jax.jit
            def sp_step(states, buf, aux, key, golden, calib, sel_base):
                eval_fn = make_eval_fn(self.model, golden)
                return selfplay_step_tiered(
                    states, buf, aux, key, eval_fn, params_sel, params_fast,
                    cfg, calib=calib, sel_mult_base=sel_base)
        self._sp_steps = sp_step

    def selfplay_games(self, num_games: int, max_plies: int = 100000) -> int:
        if self._sp_steps is None:
            self._bind_selfplay()
        start_games = self.replay.games_added
        plies = 0
        last_harvest = 0
        B = self.cfg.selfplay_batch_size
        while (self.replay.games_added - start_games) < num_games \
                and plies < max_plies:
            if self.tree is not None and self.bias is not None:
                (self.states, self.buf, self.aux, self.tree, self.bias,
                 self.key) = self._sp_steps(
                    self.states, self.buf, self.aux, self.tree, self.bias,
                    self.key, self.golden, self.calib, self.sel_mult_base)
            elif self.tree is not None:
                (self.states, self.buf, self.aux, self.tree,
                 self.key) = self._sp_steps(
                    self.states, self.buf, self.aux, self.tree, self.key,
                    self.golden, self.calib, self.sel_mult_base)
            else:
                self.states, self.buf, self.aux, self.key = \
                    self._sp_steps(self.states, self.buf, self.aux,
                                   self.key, self.golden,
                                   self.calib, self.sel_mult_base)
            plies += 1
            # Pass-alive checkpoint poll (self_play_thread.cc:701-705 +
            # board.cc:587-590), amortized over PA_POLL_PLIES moves.
            if plies % 8 == 0:
                self.states = self._pa_refresh(self.states)
            # Harvest in batches: scoring a finished game runs full Benson
            # over the whole lockstep batch, so amortize it (finished
            # boards stay frozen until reset).
            done = finished_mask(self.states, self.sp_cfg)
            ndone = int(jnp.sum(done))
            if ndone > 0 and (ndone >= max(B // 16, 1)
                              or plies - last_harvest >= 16):
                self._harvest(np.asarray(done))
                last_harvest = plies
        done = finished_mask(self.states, self.sp_cfg)
        if bool(jnp.any(done)):
            self._harvest(np.asarray(done))
        return self.replay.games_added - start_games

    def _harvest(self, done: np.ndarray):
        idx = np.flatnonzero(done)
        bs, ws, own = self._score_fn(self.states)
        buf_np = jax.tree_util.tree_map(np.asarray, self.buf)
        counts = np.asarray(self.states.move_count)
        komi = np.asarray(self.states.komi)
        for b in idx:
            L = min(int(counts[b]), self.sp_cfg.max_game_len)
            mv0 = int(self._init_mv[b])  # restart offset; rows < mv0 empty
            ex = finalize_game(
                stones=buf_np.stones[b], last_moves=buf_np.last_moves[b],
                to_move=buf_np.to_move[b], pi=buf_np.pi[b],
                move=buf_np.move[b],
                root_q_outcome=buf_np.root_q_outcome[b],
                root_score=buf_np.root_score[b], kld=buf_np.kld[b],
                trainable=buf_np.trainable[b],
                mcts_value_dist=buf_np.mcts_value_dist[b],
                num_moves=L,
                black_score=float(bs[b]), white_score=float(ws[b]),
                ownership=np.asarray(own[b]), komi=float(komi[b]))
            if ex is not None:
                if (self.cfg.val_game_frac > 0
                        and self._np_rng.uniform() < self.cfg.val_game_frac):
                    self.val_replay.add_game(ex)
                else:
                    self.replay.add_game(ex)
                if self.game_sink is not None:
                    self.game_sink(ex)
            # Per-move diagnostics for the .stats pipeline
            # (tf_recorder.cc RecordGame move_stats accumulation).
            self._move_stats.append(MoveStatsBatch(
                sampled_raw_policy=buf_np.sampled_raw[b, :L],
                nn_q=buf_np.nn_q[b, :L],
                mcts_q=buf_np.mcts_q[b, :L],
                nn_mcts_diff=buf_np.nn_mcts_diff[b, :L],
                v_outcome_stddev=buf_np.v_stddev[b, :L],
                prior_entropy=buf_np.prior_entropy[b, :L],
                nn_uncertainty=buf_np.nn_uncertainty[b, :L],
                kld=buf_np.kld[b, :L],
                pre_kld=buf_np.pre_kld[b, :L],
                sel_mult_modifier=buf_np.sel_mult_modifier[b, :L],
                sel_mult_modifier_weight=buf_np.sel_weight[b, :L],
                visit_count=buf_np.visits[b, :L].astype(np.float32),
                visit_count_pre=buf_np.visit_count_pre[b, :L]))
            self.reuse.maybe_add_from_game(
                buf_np.stones[b][mv0:L], buf_np.last_moves[b][mv0:L],
                buf_np.to_move[b][mv0:L], L - mv0)
            # Fork manager: stage this game's fork decision
            # (MaybeFork/FinalizeGame deferred to harvest, fork.py).
            if self.fork is not None and L - mv0 > 0:
                rec = GameRecord(
                    stones=buf_np.stones[b][mv0:L],
                    last_moves=buf_np.last_moves[b][mv0:L],
                    to_move=buf_np.to_move[b][mv0:L],
                    move=buf_np.move[b][mv0:L],
                    nn_value=buf_np.nn_q[b][mv0:L],
                    mcts_value=buf_np.root_q_outcome[b][mv0:L],
                    mcts_score=buf_np.root_score[b][mv0:L],
                    eligible=(~buf_np.sampled_raw[b][mv0:L]
                              & (buf_np.visits[b][mv0:L] > 0)),
                    komi=float(komi[b]),
                    winner=1 if float(bs[b]) > float(ws[b]) else -1,
                    init_mv_num=mv0)
                self.fork.process_game(self._fork_plans[b], rec)
            if self.sgf_dir:
                os.makedirs(self.sgf_dir, exist_ok=True)
                sgf = game_to_sgf(buf_np.to_move[b], buf_np.move[b], L,
                                  float(bs[b]), float(ws[b]), float(komi[b]))
                with open(os.path.join(
                        self.sgf_dir,
                        f"g{self.replay.games_added:06d}_b{b}.sgf"),
                        "w") as f:
                    f.write(sgf)

        # Flush staged fork jobs' batched NN rounds into the reuse buffer.
        if self.fork is not None:
            self.fork.flush(self.golden)

        # Per-board restarts (GetInitState, self_play_thread.cc:203-254).
        (init_states, use_init, komi_arr, no_raw,
         force_sel) = self._build_restart_batch(idx)
        self.key, kreset = jax.random.split(self.key)
        out = reset_finished(
            self.states, self.buf, self.aux, jnp.asarray(done),
            komi_arr, kreset, init_states, use_init,
            max_raw_policy_moves=self.sp_cfg.max_raw_policy_moves,
            reuse_tree=self.tree, no_raw=no_raw, force_sel=force_sel,
            bias_table=self.bias)
        if self.tree is not None and self.bias is not None:
            self.states, self.buf, self.aux, self.tree, self.bias = out
        elif self.tree is not None:
            self.states, self.buf, self.aux, self.tree = out
        else:
            self.states, self.buf, self.aux = out

    # Free-handicap placement (board.cc:479-480 kHandicapStones), flat idx.
    _HANDICAP_STONES = (15 * 19 + 3, 3 * 19 + 15, 3 * 19 + 3, 15 * 19 + 15)

    def _note_new_game(self, b: int, is_fresh: bool, init_mv: int):
        self._is_fresh[b] = is_fresh
        self._init_mv[b] = init_mv
        self._fork_plans[b] = (self.fork.new_plan(is_fresh)
                               if self.fork is not None else None)

    def _build_restart_batch(self, done_idx):
        """Per-board restart positions (GetInitState,
        self_play_thread.cc:203-254): randomized komi for fresh games, 5%
        handicap starts, use_seen_state_prob reuse-buffer restarts with
        their stored komi/first-move behavior; updates fork-plan and
        freshness bookkeeping for every restarted board.

        -> (init_states, use_init, komi [B], no_raw [B], force_sel [B])."""
        from p3achygo_tpu.constants import NOOP_MOVE
        from p3achygo_tpu.game.board import from_stones

        B = self.cfg.selfplay_batch_size
        rng = self._np_rng
        cfg = self.cfg
        stones = np.zeros((B, 361), np.int8)
        last_moves = np.full((B, 5), NOOP_MOVE, np.int32)
        to_move = np.ones((B,), np.int8)
        move_num = np.zeros((B,), np.int32)
        komi = np.full((B,), self.sp_cfg.komi, np.float32)
        no_raw = np.zeros((B,), bool)
        force = np.zeros((B,), bool)
        use = np.zeros((B,), bool)
        for b in done_idx:
            use[b] = True
            if cfg.randomize_komi:
                komi[b] = (np.round(7.0 + np.clip(rng.normal(), -3.0, 3.0))
                           + (0.5 if rng.uniform() < 0.5 else -0.5))
            p = rng.uniform()
            if p <= cfg.play_from_book_prob:
                # Opening book (GetInitState, self_play_thread.cc:216-232):
                # random prefix of a random fixed line, BLACK first.
                from p3achygo_tpu.selfplay.book import sample_book_prefix

                prefix = sample_book_prefix(rng)
                color = 1
                moves = []
                for loc in prefix:
                    stones[b, loc] = color
                    moves.append(loc)
                    color = -color
                for i, loc in enumerate(moves[-5:]):
                    last_moves[b, 5 - len(moves[-5:]) + i] = loc
                to_move[b] = color
                move_num[b] = len(moves)
                self._note_new_game(b, is_fresh=True, init_mv=len(moves))
            elif p <= cfg.play_from_book_prob + cfg.handicap_game_prob:
                h = int(np.floor(rng.uniform() * 3 + 2))  # 2..4 stones
                komi[b] = (h - 2) * 14 + 20.5  # katago ;) (ssp.cc:238)
                for loc in self._HANDICAP_STONES[:h]:
                    stones[b, loc] = 1
                to_move[b] = -1  # WHITE moves first
                self._note_new_game(b, is_fresh=True, init_mv=0)
            elif (p <= cfg.play_from_book_prob + cfg.handicap_game_prob
                  + cfg.use_seen_state_prob and len(self.reuse) > 0):
                st = self.reuse.get()
                if st is None:
                    self._note_new_game(b, is_fresh=True, init_mv=0)
                    continue
                stones[b] = st.stones
                last_moves[b] = st.last_moves
                to_move[b] = st.to_move
                move_num[b] = st.move_num
                if st.komi is not None:
                    komi[b] = st.komi
                no_raw[b] = st.first_move_behavior != FMB_SAMPLE
                force[b] = st.first_move_behavior == FMB_FORCE_FULL_SEARCH
                self._note_new_game(b, is_fresh=False, init_mv=st.move_num)
            else:
                self._note_new_game(b, is_fresh=True, init_mv=0)
        init = jax.vmap(lambda s, lm, c, k, m: from_stones(
            s, k, 1)._replace(
                last_moves=lm.astype(jnp.int32),
                to_move=c.astype(jnp.int8),
                move_count=m))(
            jnp.asarray(stones), jnp.asarray(last_moves),
            jnp.asarray(to_move), jnp.asarray(komi), jnp.asarray(move_num))
        return (init, jnp.asarray(use), jnp.asarray(komi),
                jnp.asarray(no_raw), jnp.asarray(force))

    # ---------------- training ----------------
    def train_epoch(self, num_steps: Optional[int] = None,
                    window: Optional[int] = None):
        steps = num_steps or max(len(self.replay) // self.cfg.train_batch_size,
                                 1)
        if window is None:
            # KataGo-style train_window_size growth (shuffle.py:175-186 +
            # shuffle_metadata.py:9-26): stale early generations age out.
            window = self.replay.training_window()
        losses = {}
        for _ in range(steps):
            batch = self.replay.sample(self.cfg.train_batch_size, window)
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            self.key, kp = jax.random.split(self.key)
            planes, scalars, targets = self._prepare(kp, batch)
            self.train_state, losses = self._train_step(
                self.train_state, planes, scalars, targets)
            self.snapshots.maybe_snapshot(int(self.train_state.step),
                                          self.train_state.params)
        return {k: float(v) for k, v in losses.items()}

    def _bn_batches(self, num_passes: int):
        """(planes, scalars) batches for the BN refresh, drawn from the
        training window."""
        window = self.replay.training_window()
        for _ in range(num_passes):
            batch = self.replay.sample(self.cfg.train_batch_size, window)
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            self.key, kp = jax.random.split(self.key)
            planes, scalars, _ = self._prepare(kp, batch)
            yield planes, scalars

    def validate(self, num_batches: Optional[int] = None) -> dict:
        """Held-out losses + accuracy metrics (train.py:1038 val), plus a
        rendered sample-board diagnostic per generation
        (log_board_position, train.py:748-1020)."""
        num_batches = num_batches or self.cfg.val_batches
        if len(self.val_replay) == 0 or num_batches <= 0:
            return {}
        variables = {"params": self.train_state.params,
                     "batch_stats": self.train_state.batch_stats}
        totals: dict = {}
        last = None
        for _ in range(num_batches):
            batch = self.val_replay.sample(self.cfg.train_batch_size)
            batch = {k: jnp.asarray(v) for k, v in batch.items()}
            self.key, kp = jax.random.split(self.key)
            planes, scalars, targets = self._prepare_val(kp, batch)
            out = self._val_fn(variables, planes, scalars, targets)
            last = (planes, scalars, targets)
            for key, val in out.items():
                totals[key] = totals.get(key, 0.0) + float(val)
        if last is not None:
            try:
                from p3achygo_tpu.train.render import render_sample

                planes, scalars, targets = last
                outputs = self.model.apply(variables, planes, scalars,
                                           train=False)
                with open(os.path.join(self.root, "train_samples.txt"),
                          "a") as f:
                    f.write(f"\n# generation {self.gen}\n")
                    f.write(render_sample(planes, scalars, outputs, targets))
                    f.write("\n")
            except Exception:  # diagnostics must never kill the run
                pass
        return {f"val_{k}": v / num_batches for k, v in totals.items()}

    # ---------------- eval + promotion ----------------
    def build_candidate(self, swa: bool = True) -> dict:
        cand_params = self.snapshots.final(self.train_state.params) if swa \
            else self.train_state.params
        cand_bs = self.train_state.batch_stats
        # SWA-averaged weights shift activation statistics: refresh the BN
        # running stats with forward passes before gating
        # (model_utils.py:42-116 recompute_bn_statistics).
        passes = self.cfg.bn_recompute_passes
        if swa and passes > 0 and len(self.replay) > 0 and cand_bs:
            cand_bs = recompute_batch_stats(
                self.model, cand_params, cand_bs, self._bn_batches(passes),
                num_passes=passes, fwd_fn=self._bn_fwd)
        return {"params": cand_params, "batch_stats": cand_bs}

    def evaluate_candidate(self, swa: bool = True,
                           cand: Optional[dict] = None):
        if cand is None:
            cand = self.build_candidate(swa)
        # Eval n grows min_eval_n -> eval_n over eval_n_growth_window
        # (get_eval_n, train_sp_eval.py:70-74); rebind the runner (and its
        # compiled ply programs) only when n actually changes.
        n_e = eval_n_for_gen(self.cfg, self.gen)
        games_e = eval_games_for_gen(self.cfg, self.gen)
        if getattr(self, "_eval_n", None) != (n_e, games_e):
            ev_cfg = EvalConfig(
                num_games=games_e,
                max_game_len=self.cfg.eval_max_game_len,
                search=SearchParams(n=n_e, k=self.cfg.eval_k,
                                    noise_scale=1.0, tau=0.0,
                                    terminal_mode=self.cfg.terminal_mode))
            self._eval_runner = EvalRunner(self.model, ev_cfg)
            self._eval_n = (n_e, games_e)
        self.key, ke = jax.random.split(self.key)
        res = self._eval_runner.run(ke, cand, self.golden)
        return res, cand

    def _flush_stats(self):
        """Write this generation's .stats file and refresh the sel_mult
        calibration for the next one (tf_recorder.cc:313-461 +
        sp_loop.py:140-157)."""
        if not self._move_stats:
            return
        os.makedirs(self.stats_dir, exist_ok=True)
        stats = MoveStatsBatch.concatenate(self._move_stats)
        self._move_stats = []
        n = int(stats.nn_q.size)
        ts = int(time.time())
        name = f"gen{self.gen:03d}_b000_g000_n{n:05d}_t{ts}_w0.stats"
        write_stats_file(os.path.join(self.stats_dir, name), stats)
        calib = compute_calibration(self.stats_dir, self.gen)
        if calib is not None:
            write_calibration_file(
                calib, os.path.join(self.root, "sel_mult_calib.txt"))
            self.calib = calibration_from_dict(calib)
            base = compute_sel_mult_base(calib)
            if base is not None:
                self.sel_mult_base = jnp.float32(base)

    def run_generation(self, eval_gating: bool = True) -> dict:
        t0 = time.time()
        games = self.cfg.games_first_gen if self.gen == 0 \
            else self.cfg.games_per_gen
        self.selfplay_games(games)
        self._flush_stats()
        sp_t = time.time() - t0
        out = self.train_and_gate(eval_gating)
        return dict(games=games, selfplay_s=sp_t, **out)

    def train_and_gate(self, eval_gating: bool = True) -> dict:
        """Train on the replay, gate the candidate, checkpoint, advance the
        generation. The selfplay-free half of run_generation — the learner
        worker (rl/workers.py) calls this after ingesting chunks from the
        store bus (train_sp_eval.py loop body minus sp_loop)."""
        t0 = time.time()
        # Per-generation LR (get_lr, rl_loop/train.py:33-49), injected into
        # the opt_state hyperparams — no recompile, momentum preserved.
        lr = lr_for_gen(self.cfg, self.gen)
        self.train_state.opt_state.hyperparams["learning_rate"] = \
            jnp.asarray(lr, jnp.float32)
        losses = self.train_epoch()
        losses["lr"] = lr
        losses.update(self.validate())
        train_t = time.time() - t0

        promoted = True
        elo = 0.0
        if eval_gating:
            cand = self.build_candidate()
            # Candidate-first checkpointing (train_sp_eval.py:213-215: the
            # model is uploaded BEFORE eval so a crash during gating never
            # loses the training work).
            save_named(self.root, "cand", cand)
            res, _ = self.evaluate_candidate(cand=cand)
            elo = res.elo
            promoted = res.elo > 0
            if promoted:
                self.golden = cand
        else:
            self.golden = {"params": self.train_state.params,
                           "batch_stats": self.train_state.batch_stats}

        old_nk = (gumbel_params_for_gen(self.cfg, self.gen, True),
                  gumbel_params_for_gen(self.cfg, self.gen, False))
        self.gen += 1
        new_nk = (gumbel_params_for_gen(self.cfg, self.gen, True),
                  gumbel_params_for_gen(self.cfg, self.gen, False))
        if new_nk != old_nk:
            self._sp_steps = None  # n/k changed: rebind (weights are traced)
        save_checkpoint(self.root, self.gen, {
            "params": self.golden["params"],
            "batch_stats": self.golden["batch_stats"],
            "step": self.train_state.step,
        }, live=False)
        with open(os.path.join(self.root, "elo_history.txt"), "a") as f:
            f.write(f"{self.gen} {elo:.2f} {int(promoted)}\n")
        self.save_resume()
        return dict(gen=self.gen, elo=elo, promoted=promoted,
                    train_s=train_t, **losses)

    # ---------------- resume (elastic recovery) ----------------
    # The reference rediscovers run state from GCS on restart
    # (fs_utils.py:25-65 get_most_recent_model + train_sp_eval.py:213-215);
    # here the generation boundary is the durable point: full train state +
    # golden + replay ring land on disk after every generation, and
    # `try_resume` picks the run back up from there. In-flight selfplay
    # games at crash time are lost, matching the reference's thread games.
    def _resume_template(self) -> dict:
        return {
            "params": self.train_state.params,
            "batch_stats": self.train_state.batch_stats,
            "opt_state": self.train_state.opt_state,
            "step": self.train_state.step,
            "golden_params": self.golden["params"],
            "golden_batch_stats": self.golden["batch_stats"],
            "key": self.key,
            "sel_mult_base": self.sel_mult_base,
        }

    def save_resume(self):
        save_named(self.root, "live", self._resume_template())
        self.replay.save(os.path.join(self.root, "replay.npz"))
        self.val_replay.save(os.path.join(self.root, "val_replay.npz"))
        meta = {"gen": self.gen,
                "np_rng_state": self._np_rng.bit_generator.state}
        tmp = os.path.join(self.root, "resume_meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.root, "resume_meta.json"))

    def try_resume(self) -> bool:
        """Restore run state saved by `save_resume`; returns True if the
        loop was resumed (self.gen advanced past 0)."""
        meta_path = os.path.join(self.root, "resume_meta.json")
        live_path = os.path.join(self.root, "live")
        if not (os.path.exists(meta_path) and os.path.isdir(live_path)):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        state = restore_checkpoint(live_path, self._resume_template())
        self.train_state = TrainState(
            params=state["params"], batch_stats=state["batch_stats"],
            opt_state=state["opt_state"], step=state["step"])
        self.golden = {"params": state["golden_params"],
                       "batch_stats": state["golden_batch_stats"]}
        self.key = state["key"]
        self.sel_mult_base = state["sel_mult_base"]
        self.gen = int(meta["gen"])
        self._np_rng.bit_generator.state = meta["np_rng_state"]
        for buf, fname in ((self.replay, "replay.npz"),
                          (self.val_replay, "val_replay.npz")):
            path = os.path.join(self.root, fname)
            if os.path.exists(path):
                buf.load(path)
        # sel_mult calibration comes back from the on-disk .stats files
        # (sp_loop.py:140-157), exactly as _flush_stats derives it.
        calib = compute_calibration(self.stats_dir, self.gen)
        if calib is not None:
            self.calib = calibration_from_dict(calib)
        self._sp_steps = None  # rebind: n/k may differ at the resumed gen
        return True
