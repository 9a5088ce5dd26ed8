"""Vectorized self-play driver.

Replaces the reference's thread-per-game loop (cc/selfplay/self_play_thread.cc
Run :309-920) with one lockstep array program: a batch of B games advances
one move per jitted step (search -> temperature sampling -> superko guard ->
board step -> record write). Finished games are finalized on the host
(TD targets, tf_recorder.cc:186-215 semantics) and their slots reset to
fresh games, so the batch is always full.

Reference knobs carried over: temperature decay 0.8 -> ~0.2 with half-life
19 moves (self_play_thread.cc:570-581), resign disabled by default, max game
length cap. Playout-cap randomization (selected/fast move tiers) is a
batch-global coin flip per step for now — per-board search-size bucketing is
a planned optimization (SURVEY.md §7 hard parts: heterogeneous budgets).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import (
    BLACK,
    MAX_GAME_LEN,
    NUM_LAST_MOVES,
    NUM_LOCS,
    NUM_MOVES,
    PASS_MOVE,
    WHITE,
)
from p3achygo_tpu.game.board import (
    GoState,
    is_game_over,
    new_state,
    step,
    superko_violation,
)
from p3achygo_tpu.game.scoring import score as score_board
from p3achygo_tpu.mcts.gumbel import EvalFn, SearchParams, search_root


@dataclasses.dataclass(frozen=True)
class SelfplayConfig:
    batch_size: int = 64
    komi: float = 7.5
    max_game_len: int = MAX_GAME_LEN
    # search tiers (selfplay/main.cc:40-47: selected n=128 k=8,
    # default n=32 k=5 at scale; small defaults here for bring-up)
    selected_n: int = 32
    selected_k: int = 4
    fast_n: int = 16
    fast_k: int = 4
    trainable_move_prob: float = 0.25  # kMoveSelectedForTrainingProb
    # temperature schedule (self_play_thread.cc:570-581)
    tau_initial: float = 0.8
    tau_min: float = 0.2
    tau_half_life: int = 19
    noise_scale: float = 1.0
    disable_pass_initial_moves: int = 0
    # raw-policy opening cap (kMaxNumRawPolicyMoves, self_play_thread.cc:44)
    max_raw_policy_moves: int = 30
    # tree reuse across moves (self_play_thread.cc:709-727 tree reuse+Reap);
    # capacity of the carried subtree (>= largest tier's n + 2)
    tree_reuse: bool = True
    # sel_mult signal strength in [0, 1] (SPConfig.sel_mult_scale_factor,
    # self_play_thread.h:47-49); the base multiplier itself is a traced
    # argument of selfplay_step (per-generation calibration).
    sel_mult_scale_factor: float = 1.0
    # Independent tier-permutation groups. The per-step playout-cap draw
    # permutes boards into selected/fast sub-batches; with 1 group the
    # argsort spans the GLOBAL batch, which under multi-host data sharding
    # all-gathers every board's state every ply (measured: the dominant
    # scaling cost over slow interconnect, benchmarks/multihost_scaling).
    # Set = number of data shards (hosts) to keep the permutation
    # shard-local: each group draws its own B_sel/groups selected boards —
    # same marginal tier distribution, zero cross-shard traffic.
    tier_groups: int = 1


class GameBuffer(NamedTuple):
    """Per-move device records for in-flight games [B, T, ...]."""

    stones: jnp.ndarray  # int8[B, T, 361] position BEFORE the move
    last_moves: jnp.ndarray  # int16[B, T, 5]
    to_move: jnp.ndarray  # int8[B, T]
    pi: jnp.ndarray  # f32[B, T, 362] improved policy
    move: jnp.ndarray  # int16[B, T] move played
    root_q_outcome: jnp.ndarray  # f32[B, T] stitched root outcome value
    root_score: jnp.ndarray  # f32[B, T] root score estimate
    kld: jnp.ndarray  # f32[B, T]
    trainable: jnp.ndarray  # bool[B, T]
    visits: jnp.ndarray  # int32[B, T]
    mcts_value_dist: jnp.ndarray  # int16[B, T, 51] root value histogram
    # --- per-move search diagnostics (MoveSearchStats,
    #     move_search_stats.h:16-33), harvested into .stats files ---
    sampled_raw: jnp.ndarray  # bool[B, T]
    nn_q: jnp.ndarray  # f32[B, T] root init_util_est
    mcts_q: jnp.ndarray  # f32[B, T] pre-search root Q (tree reuse)
    nn_mcts_diff: jnp.ndarray  # f32[B, T] |qz_nn - q_pre| pre-search
    v_stddev: jnp.ndarray  # f32[B, T] pre-search sqrt(v_outcome_var)
    prior_entropy: jnp.ndarray  # f32[B, T] H(root priors)
    nn_uncertainty: jnp.ndarray  # f32[B, T] root init_err_est
    pre_kld: jnp.ndarray  # f32[B, T] pre-search KLD(improved || prior)
    sel_mult_modifier: jnp.ndarray  # f32[B, T]
    sel_weight: jnp.ndarray  # f32[B, T] base-prob fraction (down-bad anneal)
    visit_count_pre: jnp.ndarray  # f32[B, T]


def make_game_buffer(B: int, T: int) -> GameBuffer:
    return GameBuffer(
        stones=jnp.zeros((B, T, NUM_LOCS), jnp.int8),
        last_moves=jnp.zeros((B, T, NUM_LAST_MOVES), jnp.int16),
        to_move=jnp.zeros((B, T), jnp.int8),
        pi=jnp.zeros((B, T, NUM_MOVES), jnp.float32),
        move=jnp.zeros((B, T), jnp.int16),
        root_q_outcome=jnp.zeros((B, T), jnp.float32),
        root_score=jnp.zeros((B, T), jnp.float32),
        kld=jnp.zeros((B, T), jnp.float32),
        trainable=jnp.zeros((B, T), jnp.bool_),
        visits=jnp.zeros((B, T), jnp.int32),
        mcts_value_dist=jnp.zeros((B, T, 51), jnp.int16),
        sampled_raw=jnp.zeros((B, T), jnp.bool_),
        nn_q=jnp.zeros((B, T), jnp.float32),
        mcts_q=jnp.zeros((B, T), jnp.float32),
        nn_mcts_diff=jnp.zeros((B, T), jnp.float32),
        v_stddev=jnp.zeros((B, T), jnp.float32),
        prior_entropy=jnp.zeros((B, T), jnp.float32),
        nn_uncertainty=jnp.zeros((B, T), jnp.float32),
        pre_kld=jnp.zeros((B, T), jnp.float32),
        sel_mult_modifier=jnp.zeros((B, T), jnp.float32),
        sel_weight=jnp.zeros((B, T), jnp.float32),
        visit_count_pre=jnp.zeros((B, T), jnp.float32),
    )


class SelfplayAux(NamedTuple):
    """Per-board selfplay loop state beyond the Go position."""

    raw_until: jnp.ndarray  # int32[B]: sample raw policy while move < this
    down_bad_count: jnp.ndarray  # int32[B]: consecutive |qz| > 0.9 moves
    # FirstMoveBehavior::kForceFullSearch (reuse_buffer.h:19-26): the next
    # move of these boards runs the selected tier and is trainable
    # regardless of the tier coin; cleared after one move
    # (self_play_thread.cc:322-327, :541-545).
    force_sel: jnp.ndarray  # bool[B]


def make_aux(key: jax.Array, B: int,
             max_raw_moves: int = 30) -> SelfplayAux:
    """Fresh-game aux: raw-policy opening length ~ U(0, 30)
    (kMaxNumRawPolicyMoves, self_play_thread.cc:362-368)."""
    return SelfplayAux(
        raw_until=jax.random.randint(key, (B,), 0, max_raw_moves + 1),
        down_bad_count=jnp.zeros((B,), jnp.int32),
        force_sel=jnp.zeros((B,), jnp.bool_),
    )


def tau_schedule(move_count: jnp.ndarray, cfg: SelfplayConfig) -> jnp.ndarray:
    decay = 0.5 ** (move_count.astype(jnp.float32) / cfg.tau_half_life)
    return jnp.maximum(cfg.tau_initial * decay, cfg.tau_min)


DOWN_BAD_THRESHOLD = 0.90  # kDownBadThreshold (self_play_thread.cc:68)
DOWN_BAD_MOVES = 5  # kNumDownBadMovesThreshold


def _zero_pre_stats(B: int):
    from p3achygo_tpu.mcts.gumbel import RootPreStats

    z = jnp.zeros((B,), jnp.float32)
    return RootPreStats(n_pre=jnp.zeros((B,), jnp.int32), q_pre=z, qz_pre=z,
                        std_pre=z, pre_kld=z, nn_q=z, qz_nn=z,
                        nn_mcts_diff=z, q_canonical=z, nn_uncertainty=z,
                        prior_entropy=z)


def _choose_move(states: GoState, res, raw_until: jnp.ndarray,
                 kraw: jax.Array):
    """Post-search move choice shared by all tiers.

    Exact positional-superko guard on the sampled move (the in-tree mask is
    the cheap one): violating moves fall back to the deterministic
    improved-policy argmax, then to pass. Raw-policy opening moves sample
    the masked NN prior directly (self_play_thread.cc:362-368, 527-533).
    Returns (move, sampling_raw, over)."""
    B = states.stones.shape[0]
    b = jnp.arange(B)
    viol = jax.vmap(superko_violation)(states, res.mcts_move)
    alt = jnp.argmax(
        res.pi_improved.at[b, jnp.clip(res.mcts_move, 0,
                                       NUM_MOVES - 1)].set(-1.0),
        axis=-1).astype(jnp.int32)
    alt_viol = jax.vmap(superko_violation)(states, alt)
    move = jnp.where(viol, jnp.where(alt_viol, PASS_MOVE, alt), res.mcts_move)
    sampling_raw = states.move_count < raw_until
    raw_sample = jax.random.categorical(
        kraw, jnp.log(jnp.maximum(res.root_priors, 1e-30)),
        axis=-1).astype(jnp.int32)
    raw_viol = jax.vmap(superko_violation)(states, raw_sample)
    raw_sample = jnp.where(raw_viol, PASS_MOVE, raw_sample)
    move = jnp.where(sampling_raw, raw_sample, move)
    over = jax.vmap(is_game_over)(states)
    move = jnp.where(over, PASS_MOVE, move)
    return move, sampling_raw, over


def _selection_state(res, pre, aux: SelfplayAux, sampling_raw, cfg,
                     calib, sel_mult_base):
    """Down-bad annealing + sel_mult of the training-selection probability
    (self_play_thread.cc:436-537, :473-499).

    Returns (keep_prob, sel_modifier, sel_mult, down_bad_count)."""
    from p3achygo_tpu.selfplay.move_sel import (
        compute_move_sel,
        default_calibration,
    )

    B = res.root_outcome.shape[0]
    qz = res.root_outcome
    is_bad = jnp.abs(qz) > DOWN_BAD_THRESHOLD
    down_bad_count = jnp.where(is_bad, aux.down_bad_count + 1, 0)
    is_down_bad = down_bad_count >= DOWN_BAD_MOVES
    coeff = jnp.clip((1.0 - jnp.abs(qz)) / (1.0 - DOWN_BAD_THRESHOLD), 0, 1)
    keep_prob = jnp.where(is_down_bad, coeff * coeff, 1.0)

    if calib is None:
        calib = default_calibration()
    sel = compute_move_sel(pre.n_pre, pre.std_pre, pre.pre_kld,
                           pre.nn_mcts_diff, pre.q_canonical,
                           cfg.sel_mult_scale_factor, calib)
    sel_modifier = jnp.where(sampling_raw, 1.0, sel.modifier)
    if sel_mult_base is None:
        sel_mult = jnp.ones((B,), jnp.float32)
    else:
        base = jnp.asarray(sel_mult_base, jnp.float32)
        sel_mult = jnp.where(base > 0, base * sel_modifier, 1.0)
    return keep_prob, sel_modifier, sel_mult, down_bad_count


def _record_and_advance(states: GoState, buf: GameBuffer, res, move,
                        sampling_raw, over, pre, nn_q_root, nn_unc_root,
                        trainable, keep_prob, sel_modifier, cfg):
    """Write per-move records for active boards and step the batch."""
    B = states.stones.shape[0]
    b = jnp.arange(B)
    t = jnp.clip(states.move_count, 0, cfg.max_game_len - 1)
    active = ~over
    wr = lambda arr, val, dtype=None: arr.at[b, t].set(
        jnp.where(jnp.reshape(active, (B,) + (1,) * (val.ndim - 1)),
                  val.astype(arr.dtype), arr[b, t]))
    buf = buf._replace(
        stones=wr(buf.stones, states.stones),
        last_moves=wr(buf.last_moves, states.last_moves),
        to_move=wr(buf.to_move, states.to_move),
        pi=wr(buf.pi, res.pi_improved),
        move=wr(buf.move, move),
        root_q_outcome=wr(buf.root_q_outcome, res.root_outcome),
        root_score=wr(buf.root_score, res.root_score_est),
        kld=wr(buf.kld, res.kld),
        visits=wr(buf.visits, res.visits),
        mcts_value_dist=wr(buf.mcts_value_dist, res.root_value_dist),
        trainable=buf.trainable.at[b, t].set(
            jnp.where(active, trainable, buf.trainable[b, t])),
        # MoveSearchStats diagnostics (self_play_thread.cc:646-668):
        # nn_q / nn_uncertainty from the post-search root (init fields are
        # written by this search for fresh roots); pre-search signals from
        # the reused tree.
        sampled_raw=buf.sampled_raw.at[b, t].set(
            jnp.where(active, sampling_raw, buf.sampled_raw[b, t])),
        nn_q=wr(buf.nn_q, nn_q_root),
        mcts_q=wr(buf.mcts_q, pre.q_pre),
        nn_mcts_diff=wr(buf.nn_mcts_diff, pre.nn_mcts_diff),
        v_stddev=wr(buf.v_stddev, pre.std_pre),
        prior_entropy=wr(buf.prior_entropy, -jnp.sum(
            jnp.where(res.root_priors > 0,
                      res.root_priors * jnp.log(res.root_priors + 1e-10),
                      0.0), axis=-1)),
        nn_uncertainty=wr(buf.nn_uncertainty, nn_unc_root),
        pre_kld=wr(buf.pre_kld, pre.pre_kld),
        sel_mult_modifier=wr(buf.sel_mult_modifier, sel_modifier),
        sel_weight=wr(buf.sel_weight, keep_prob),
        visit_count_pre=wr(buf.visit_count_pre,
                           pre.n_pre.astype(jnp.float32)),
    )

    new_states, _ = jax.vmap(step)(states, move)
    # Finished boards stay frozen until reset.
    states = jax.tree_util.tree_map(
        lambda new, old: jnp.where(
            jnp.reshape(active, (B,) + (1,) * (new.ndim - 1)), new, old),
        new_states, states)
    return states, buf


def selfplay_step(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                  key: jax.Array, eval_fn: EvalFn, params: SearchParams,
                  cfg: SelfplayConfig, selected_tier: bool,
                  reuse_tree=None, reuse_capacity: int = 0,
                  calib=None, sel_mult_base=None):
    """One lockstep move for the whole batch.

    `selected_tier` (static) marks this step as a full-search step; only
    selected-tier, non-raw-policy, non-down-bad-suppressed moves become
    trainable records (kMoveSelectedForTrainingProb semantics applied as a
    batch-global tier flip by the caller + per-board annealing here,
    self_play_thread.cc:509-537).

    `calib` (SelMultCalibration) and `sel_mult_base` (traced f32 scalar,
    <= 0 disables) scale the training-selection probability by the
    sel_mult modifier computed from pre-search signals of the reused tree
    (self_play_thread.cc:473-499); both are traced so per-generation
    calibration never recompiles this program.
    """
    B = states.stones.shape[0]
    key, ksearch, kraw, ksel = jax.random.split(key, 4)

    # Pre-search root stats from the reused tree (self_play_thread.cc:
    # 459-482) — must be read BEFORE the search mutates the root.
    from p3achygo_tpu.mcts.gumbel import root_pre_stats

    if reuse_tree is not None:
        pre = root_pre_stats(reuse_tree, params.c_visit, params.c_scale)
    else:
        pre = _zero_pre_stats(B)

    tau = tau_schedule(states.move_count, cfg)
    if reuse_tree is not None:
        res, work_tree = search_root(ksearch, states, eval_fn, params,
                                     tau=tau, init_tree=reuse_tree,
                                     reuse_capacity=reuse_capacity)
    else:
        res = search_root(ksearch, states, eval_fn, params, tau=tau)
        work_tree = None

    move, sampling_raw, over = _choose_move(states, res, aux.raw_until, kraw)
    keep_prob, sel_modifier, sel_mult, down_bad_count = _selection_state(
        res, pre, aux, sampling_raw, cfg, calib, sel_mult_base)
    trainable = jnp.where(
        aux.force_sel, ~sampling_raw,
        jnp.bool_(selected_tier) & ~sampling_raw
        & (jax.random.uniform(ksel, (B,)) < keep_prob * sel_mult))

    nn_q_root = (work_tree.init_util[:, 0] if work_tree is not None
                 else pre.nn_q)
    nn_unc_root = (work_tree.init_err[:, 0] if work_tree is not None
                   else pre.nn_uncertainty)
    states, buf = _record_and_advance(states, buf, res, move, sampling_raw,
                                      over, pre, nn_q_root, nn_unc_root,
                                      trainable, keep_prob, sel_modifier, cfg)
    aux = SelfplayAux(raw_until=aux.raw_until, down_bad_count=down_bad_count,
                      force_sel=jnp.zeros_like(aux.force_sel))
    if work_tree is not None:
        from p3achygo_tpu.mcts.tree import compact_subtree

        next_tree = compact_subtree(work_tree, move, reuse_capacity)
        return states, buf, aux, next_tree, key
    return states, buf, aux, key


def selfplay_step_tiered(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                         key: jax.Array, eval_fn: EvalFn,
                         params_sel: SearchParams, params_fast: SearchParams,
                         cfg: SelfplayConfig,
                         reuse_tree=None, reuse_capacity: int = 0,
                         calib=None, sel_mult_base=None, bias_table=None):
    """One lockstep move with PER-BOARD playout-cap randomization.

    The reference picks a search tier per move per thread
    (is_move_selected_for_training, self_play_thread.cc:544-548: selected
    n=128/k=8 with prob 0.25, else fast n=32/k=5). Lockstep mapping:
    each step draws a fresh uniformly-random subset of exactly
    round(B * trainable_move_prob) boards for the selected tier (sampling
    without replacement instead of per-board coins — same marginal tier
    distribution, fixed sub-batch shapes), gathers those boards + their
    reuse trees into a compact sub-batch, and runs the two searches at
    their OWN widths. Fast boards never pay for the selected program and
    vice versa: per-step cost is 0.75*cost(fast) + 0.25*cost(selected)
    instead of lockstep worst-case.

    Deviations (documented): down-bad search-size annealing
    (self_play_thread.cc:527-537) shrinks the selection PROBABILITY here,
    not the per-board n (heterogeneous n inside a sub-batch would break
    the static visit schedule); per-game randomized fast k / noise / FPU
    (self_play_thread.cc:414-424) are not randomized per board.

    Returns (states, buf, aux, next_tree, key) when reuse_tree is given,
    else (states, buf, aux, key).
    """
    B = states.stones.shape[0]
    key, kperm, ks1, ks2, kr1, kr2, ksel = jax.random.split(key, 7)
    # Random permutation, with force-full-search boards (restart first
    # moves, reuse_buffer.h kForceFullSearch) sorted into the selected
    # subset ahead of the random draw. With tier_groups > 1 the draw is
    # INDEPENDENT PER GROUP and all gathers/scatters stay within a
    # group's rows (axis-1 ops on a [G, B/G, ...] view): under multi-host
    # data sharding with groups == shards, the tier permute is
    # shard-local — a global argsort/take all-gathered every board's
    # state every ply (see SelfplayConfig.tier_groups).
    G = max(1, min(cfg.tier_groups, B))
    assert B % G == 0, (B, G)
    Bg = B // G
    # Each group needs >= 1 selected AND >= 1 fast row (Bg == 1 would make
    # B_sel_g = min(>=1, 0) = 0: a zero-width selected search). Note also
    # that force_sel boards can only be promoted within their own group's
    # B_sel_g quota — with many groups, a burst of restarts in one group
    # silently demotes the overflow to the fast tier (bounded by B_sel_g
    # per group vs B_sel globally at G == 1).
    assert Bg >= 2, (f"tier_groups={G} leaves {Bg} board(s) per group; "
                     "need >= 2 (one per tier)")
    B_sel_g = min(max(int(round(Bg * cfg.trainable_move_prob)), 1), Bg - 1)
    B_sel = B_sel_g * G
    rnd = jax.random.uniform(kperm, (B,))
    keys_g = jnp.where(aux.force_sel, rnd - 2.0, rnd).reshape(G, Bg)
    perm_g = jnp.argsort(keys_g, axis=1)  # [G, Bg] group-local order
    inv_g = jnp.argsort(perm_g, axis=1)  # board -> rank within its group

    def take_grouped(x, idx_g):
        """Rows of x [B, ...] at group-local positions idx_g [G, m]."""
        m = idx_g.shape[1]
        xg = x.reshape(G, Bg, *x.shape[1:])
        idx = idx_g.reshape(G, m, *([1] * (x.ndim - 1)))
        out = jnp.take_along_axis(xg, idx, axis=1)
        return out.reshape(G * m, *x.shape[1:])

    tau = tau_schedule(states.move_count, cfg)

    from p3achygo_tpu.mcts.gumbel import root_pre_stats
    from p3achygo_tpu.mcts.tree import compact_subtree

    if reuse_tree is not None:
        pre = root_pre_stats(reuse_tree, params_sel.c_visit,
                             params_sel.c_scale)
    else:
        pre = _zero_pre_stats(B)

    def run_tier(idx_g, params, ksearch, kraw):
        take = lambda x: take_grouped(x, idx_g)
        st = jax.tree_util.tree_map(take, states)
        use_bias = bias_table is not None and params.bias_lambda > 0
        bt = (jax.tree_util.tree_map(take, bias_table)
              if use_bias else None)
        if reuse_tree is not None:
            tr = jax.tree_util.tree_map(take, reuse_tree)
            out = search_root(ksearch, st, eval_fn, params,
                              tau=take(tau), init_tree=tr,
                              reuse_capacity=reuse_capacity,
                              bias_table=bt)
            (res, work, bt) = out if use_bias else (*out, None)
        else:
            out = search_root(ksearch, st, eval_fn, params, tau=take(tau),
                              bias_table=bt)
            (res, bt) = out if use_bias else (out, None)
            work = None
        move, sampling_raw, over = _choose_move(st, res,
                                                take(aux.raw_until), kraw)
        if work is not None:
            ntree = compact_subtree(work, move, reuse_capacity)
            nn_q, nn_unc = work.init_util[:, 0], work.init_err[:, 0]
        else:
            ntree = None
            nn_q, nn_unc = take(pre.nn_q), take(pre.nn_uncertainty)
        return (res, move, sampling_raw, over, nn_q, nn_unc), ntree, bt

    out_sel, tree_sel, bias_sel = run_tier(perm_g[:, :B_sel_g], params_sel,
                                           ks1, kr1)
    out_fast, tree_fast, bias_fast = run_tier(perm_g[:, B_sel_g:],
                                              params_fast, ks2, kr2)

    # Scatter sub-batch results back to original board order: regroup each
    # tier's rows to [G, m, ...], concat within the group (matching the
    # perm_g order), then invert group-locally.
    def unperm(a, b_):
        ag = a.reshape(G, B_sel_g, *a.shape[1:])
        bg = b_.reshape(G, Bg - B_sel_g, *b_.shape[1:])
        merged = jnp.concatenate([ag, bg], axis=1)  # [G, Bg, ...]
        idx = inv_g.reshape(G, Bg, *([1] * (a.ndim - 1)))
        out = jnp.take_along_axis(merged, idx, axis=1)
        return out.reshape(G * Bg, *a.shape[1:])

    (res, move, sampling_raw, over, nn_q_root, nn_unc_root) = \
        jax.tree_util.tree_map(unperm, out_sel, out_fast)
    next_tree = (jax.tree_util.tree_map(unperm, tree_sel, tree_fast)
                 if reuse_tree is not None else None)
    next_bias = (jax.tree_util.tree_map(unperm, bias_sel, bias_fast)
                 if bias_sel is not None else None)

    is_sel = (inv_g < B_sel_g).reshape(-1)
    keep_prob, sel_modifier, sel_mult, down_bad_count = _selection_state(
        res, pre, aux, sampling_raw, cfg, calib, sel_mult_base)
    # Forced first moves are trainable regardless of the tier coin
    # (force_first_move, self_play_thread.cc:541-545).
    trainable = jnp.where(
        aux.force_sel, ~sampling_raw,
        is_sel & ~sampling_raw
        & (jax.random.uniform(ksel, (B,)) < keep_prob * sel_mult))

    states, buf = _record_and_advance(states, buf, res, move, sampling_raw,
                                      over, pre, nn_q_root, nn_unc_root,
                                      trainable, keep_prob, sel_modifier, cfg)
    aux = SelfplayAux(raw_until=aux.raw_until, down_bad_count=down_bad_count,
                      force_sel=jnp.zeros_like(aux.force_sel))
    if next_bias is not None:
        if next_tree is not None:
            return states, buf, aux, next_tree, next_bias, key
        return states, buf, aux, next_bias, key
    if next_tree is not None:
        return states, buf, aux, next_tree, key
    return states, buf, aux, key


def finished_mask(states: GoState, cfg: SelfplayConfig) -> jnp.ndarray:
    return jax.vmap(is_game_over)(states) | (states.move_count >= cfg.max_game_len)


def final_scores(states: GoState):
    """Batched terminal scoring -> (black, white, ownership[B, 361])."""
    return jax.vmap(score_board)(states)


def reset_finished(states: GoState, buf: GameBuffer, aux: SelfplayAux,
                   done: jnp.ndarray, komi, key: jax.Array,
                   init_states: Optional[GoState] = None,
                   use_init: Optional[jnp.ndarray] = None,
                   max_raw_policy_moves: int = 30,
                   reuse_tree=None,
                   no_raw: Optional[jnp.ndarray] = None,
                   force_sel: Optional[jnp.ndarray] = None,
                   bias_table=None):
    """Replace finished boards with fresh games (or GoExploit reuse starts)
    and clear their records.

    `komi` is a scalar or a per-board [B] array (fresh-game komi
    randomization / handicap komi, GetInitState self_play_thread.cc:205-240).
    `init_states`/`use_init` optionally supply per-board restart positions
    from the reuse buffer (GetInitState, self_play_thread.cc:203-254). The
    raw-policy opening length for restarted boards decays with the start
    move number with a half-life of 40 moves (self_play_thread.cc:362-366);
    `no_raw` marks boards whose restart behavior forbids raw-policy
    sampling, and `force_sel` forces a full search + trainable first move
    (FirstMoveBehavior kPlay / kForceFullSearch, reuse_buffer.h:19-26).
    """
    B = states.stones.shape[0]
    komi_arr = jnp.broadcast_to(jnp.asarray(komi, jnp.float32), (B,))
    repl = jax.vmap(new_state)(komi_arr)
    if init_states is not None:
        sel = done & use_init
        repl = jax.tree_util.tree_map(
            lambda init, f: jnp.where(
                jnp.reshape(sel, (B,) + (1,) * (f.ndim - 1)), init, f),
            init_states, repl)
    states = jax.tree_util.tree_map(
        lambda f, old: jnp.where(
            jnp.reshape(done, (B,) + (1,) * (f.ndim - 1)), f, old),
        repl, states)
    buf = jax.tree_util.tree_map(
        lambda arr: jnp.where(
            jnp.reshape(done, (B,) + (1,) * (arr.ndim - 1)),
            jnp.zeros_like(arr), arr),
        buf)
    max_raw = jnp.round(
        float(max_raw_policy_moves)
        * 0.5 ** (states.move_count.astype(jnp.float32) / 40.0)
    ).astype(jnp.int32)
    new_raw = jnp.floor(
        jax.random.uniform(key, (B,)) * (max_raw + 1).astype(jnp.float32)
    ).astype(jnp.int32)
    if no_raw is not None:
        new_raw = jnp.where(no_raw, 0, new_raw)
    new_force = aux.force_sel
    if force_sel is not None:
        new_force = jnp.where(done, force_sel, aux.force_sel)
    aux = SelfplayAux(
        raw_until=jnp.where(done, states.move_count + new_raw, aux.raw_until),
        down_bad_count=jnp.where(done, 0, aux.down_bad_count),
        force_sel=new_force,
    )
    if bias_table is not None:
        # The bias cache is per-game knowledge: clear finished boards'
        # rows (the reference's per-move PruneUnused fades entries the
        # same way once their game's nodes are reaped).
        from p3achygo_tpu.mcts.bias import make_bias_table

        empty_b = make_bias_table(B, bias_table.key0.shape[1])
        bias_table = jax.tree_util.tree_map(
            lambda e, t: jnp.where(
                jnp.reshape(done, (B,) + (1,) * (t.ndim - 1)), e, t),
            empty_b, bias_table)
    if reuse_tree is not None:
        from p3achygo_tpu.mcts.tree import make_tree

        empty = make_tree(B, reuse_tree.n.shape[1])
        reuse_tree = jax.tree_util.tree_map(
            lambda e, t: jnp.where(
                jnp.reshape(done, (B,) + (1,) * (t.ndim - 1)), e, t),
            empty, reuse_tree)
        if bias_table is not None:
            return states, buf, aux, reuse_tree, bias_table
        return states, buf, aux, reuse_tree
    if bias_table is not None:
        return states, buf, aux, bias_table
    return states, buf, aux
