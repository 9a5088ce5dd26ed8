"""Batched Gumbel AlphaZero root search (sequential halving), pure JAX.

Re-designs cc/mcts/gumbel.cc for lockstep array execution: the reference runs
one sequential-halving search per CPU thread with an out-of-process batched
NN server; here a whole batch of boards searches simultaneously as one
array program, and the NN evaluates all B leaves in-graph once per
simulation — batching is the array axis, no inference server needed
(SURVEY.md §2.2 redesign note).

Semantics mirrored from the reference:
- Gumbel noise + logit + q-transform ranking, sequential halving rounds
  with v = round(n / (rounds * k_r)) visits/action (gumbel.cc:388-473)
- Non-root descent by completed-Q improved-policy disparity
  (gumbel.cc:214-237, ComputeImprovedPolicy gumbel.cc:196-212)
- Leaf/terminal evaluation with score utility (leaf_evaluator.cc:85-188)
- Root improved policy over completed-Q with visit-advantage weighting
  (ComputeRootImprovedPolicy gumbel.cc:154-175), temperature-tau sampling,
  KLD(improved || prior) (gumbel.cc:183-193)
- Root stat stitching: visits from all children, value only from the
  selected child (gumbel.cc:510-557)

Deviations (documented): in-tree legality uses the cheap mask (exact
superko is enforced on real game moves, not simulated ones). Early
stopping + over-search (gumbel.cc:326-352, :397-409) are implemented with
per-board stop flags and a whole-batch round exit (SearchParams). Tree
reuse across moves is supported via init_tree/compact_subtree (see
search_root docstring).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import (
    BLACK,
    BOARD_LEN,
    NUM_LOCS,
    NUM_MOVES,
    NUM_SCORE_LOGITS,
    PASS_MOVE,
    SCORE_INFLECTION_POINT,
)
from p3achygo_tpu.game.board import (
    GoState,
    is_game_over,
    legal_mask,
    legal_mask_batch,
    point_liberties_batch,
    step,
)
from p3achygo_tpu.features import batched_features
from p3achygo_tpu.game.scoring import score as score_board
from p3achygo_tpu.game.symmetry import (
    NUM_SYMMETRIES,
    SYM_GATHER,
    SYM_SCATTER,
    apply_symmetry_action,
    apply_symmetry_grid_batch,
)
from p3achygo_tpu.mcts.tree import (
    MAX_Q,
    MIN_Q,
    NUM_V_BUCKETS,
    V_BUCKET_RANGE,
    Tree,
    child_visits,
    compact_subtree,
    make_mcgs_table,
    make_tree,
    mcgs_insert,
    mcgs_meta,
    mcgs_probe,
    saturating_edge_add,
    welford_m3_delta,
    q_nvis_of_children,
    q_of_children,
    rows_by_node,
)

_BIG_NEG = -1e9


class EvalOutput(NamedTuple):
    """Per-board NN outputs needed by search (from to-move perspective)."""

    log_priors: jnp.ndarray  # f32[B, 362] log-softmax policy
    outcome_value: jnp.ndarray  # f32[B] E[win] - E[loss]
    score_est: jnp.ndarray  # f32[B] E[score]
    score_var: jnp.ndarray  # f32[B] Var[score]
    # sqrt of the NN's short-horizon squared-error head (init_err_est =
    # sqrt(err2_outcome) = sqrt(q6_err), leaf_evaluator.cc:109); None -> 0.
    err_est: Optional[jnp.ndarray] = None  # f32[B]


EvalFn = Callable[[GoState], EvalOutput]


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration (GumbelSearchParams, gumbel.h:18-66)."""

    n: int = 32
    k: int = 4
    max_depth: int = 24
    noise_scale: float = 1.0
    tau: float = 0.0  # 0 => deterministic top candidate
    c_visit: float = 50.0
    c_scale: float = 1.0
    score_weight: float = 0.5
    # "direct" (ScoreTransform) or "integral" (Gaussian-integral table
    # mode, leaf_evaluator.h:12-16 ScoreUtilityMode).
    score_utility_mode: str = "direct"
    disable_pass: bool = False
    # In-tree terminal evaluation: "exact" runs full Benson scoring on any
    # sim that reaches a finished game (reference semantics,
    # leaf_evaluator.cc:157-188) but costs a large compiled subgraph;
    # "cheap" uses 1-step Tromp-Taylor attribution (stones + empties
    # adjacent to exactly one color), which matches exact scoring on
    # settled endgame positions. Real game results always use exact
    # scoring (selfplay harvest).
    terminal_mode: str = "cheap"
    # Confidence-based early stopping (gumbel.cc:326-352): every ceil(v/4)
    # visits within a round, a board stops its round early when every live
    # candidate's root edge has >= 10 visits and the bottom half's max
    # Q-UCB <= the top half's max Q-LCB at confidence
    # search_confidence^(1/num_rounds). Over-search (gumbel.cc:397-409)
    # instead raises the round budget to 2.5x and runs the same check from
    # v visits onward (the two modes are mutually exclusive,
    # self_play_thread.cc:544-548). Per-board: stopped boards' lanes idle
    # inside the lockstep sweep; the round's sweep loop exits entirely once
    # every board has stopped.
    early_stopping: bool = False
    over_search: bool = False
    search_confidence: float = 0.95
    # MCGS graph search (McgsNodeTable, node_table.h:78-120): leaves probe a
    # per-board (hash, color, terminal)-keyed transposition table before
    # allocating, so transposed positions share one node and its stats pool
    # across paths. See tree.py McgsTable for the design + deviations.
    use_mcgs: bool = False
    # Local-pattern value-bias cache (bias_cache.h; see mcts/bias.py).
    # lambda 0 = disabled (the reference's default, selfplay/main.cc:58);
    # when > 0 AND a BiasTable is passed to search_root, fresh leaf
    # utilities are corrected by the pattern's observed NN error and the
    # error statistics accumulate at end of search.
    bias_lambda: float = 0.0
    bias_alpha: float = 0.8
    # Grouped visits: run `visit_group` of a round's per-candidate visits in
    # ONE k*g-wide sweep instead of g sequential sweeps. Within a group the
    # tree statistics are FROZEN and the g visits are apportioned by the
    # same greedy disparity rule the reference applies sequentially
    # (gumbel.cc:214-237: argmax(pi - n/(1+sum)), with the visit/arrival
    # counters advanced per assignment) — the deviation is that Q values do
    # not refresh between the g visits of a group (they do between groups).
    # Total visits per candidate per round are unchanged (v_r), so the
    # sequential-halving budget (gumbel.cc:388-401) is exact. 1 = reference
    # semantics; >1 divides the dominant per-move latency (descent sweeps)
    # by ~g at slight search-quality cost.
    visit_group: int = 1


class GumbelResult(NamedTuple):
    mcts_move: jnp.ndarray  # int32[B]
    raw_nn_move: jnp.ndarray  # int32[B]
    pi_improved: jnp.ndarray  # f32[B, 362]
    root_value: jnp.ndarray  # f32[B] stitched root utility
    root_outcome: jnp.ndarray  # f32[B] stitched root outcome value
    root_score_est: jnp.ndarray  # f32[B] root NN score estimate
    q_selected: jnp.ndarray  # f32[B] Q of the selected move (MIN_Q if unvisited)
    qz_selected: jnp.ndarray  # f32[B] outcome-Q of the selected move
    kld: jnp.ndarray  # f32[B] KLD(improved || prior)
    visits: jnp.ndarray  # int32[B] sims spent
    root_child_visits: jnp.ndarray  # int32[B, 362]
    root_priors: jnp.ndarray  # f32[B, 362] legality-masked NN policy
    root_value_dist: jnp.ndarray  # int32[B, 51] root outcome-value histogram
    root_child_q: jnp.ndarray  # f32[B, 362] per-child Q (MIN_Q unvisited)


def make_eval_fn(model, variables, symmetrize: bool = True,
                 include_ladders: bool = False,
                 p_opt_weight: float = 0.0,
                 serve_fold: bool = False) -> EvalFn:
    """NN eval adapter: featurize states, run the model, reduce outputs.

    With `symmetrize`, each query is evaluated under a D4 symmetry picked
    deterministically from the position hash and the policy is mapped back
    (the reference applies a random symmetry per NN query and un-applies it
    on the outputs, nn_interface.cc:123-127 / nn_interface.h:262-289;
    hash-derived choice keeps eval purely functional in-graph).

    `p_opt_weight` blends the optimistic-policy head into the priors:
    probs = (1-w)*softmax(pi) + w*softmax(pi_opt) (search_policy.h:171-185
    interpolates per node; the tree stores one prior set, so the blend
    happens here once per eval — same search behavior since priors are
    write-once at node creation).

    `serve_fold` routes the model call through the folded, head-pruned
    serving graph (p3achygo_tpu/nn/serve.py — the TRT-engine analogue:
    BN affines folded into producer convs, training-only heads skipped).
    Parity: tests/test_serve_fold.py. Kept opt-in so existing compiled
    programs (the curve run's cache) stay valid; bench.py turns it on.
    """
    score_values = (jnp.arange(NUM_SCORE_LOGITS, dtype=jnp.float32)
                    - SCORE_INFLECTION_POINT + 0.5)

    serve_apply = None
    if serve_fold and getattr(model, "config", None) is not None:
        from p3achygo_tpu.nn.serve import serve_forward, serve_supported

        if serve_supported(model.config):
            serve_apply = lambda planes, scalars: serve_forward(
                model, variables, planes, scalars,
                want_optimistic=p_opt_weight > 0.0)

    # Module-level imports (top of file): importing these INSIDE a traced
    # function would stage their module-level constant tables onto the
    # active trace the first time (leaked-tracer bug when make_eval_fn is
    # first called under jit, e.g. by EvalRunner's step programs).

    def eval_fn(states: GoState) -> EvalOutput:
        if symmetrize:
            # Symmetrize the STATE, not the planes: flip/transpose selects
            # on the [B,361] int grids move a fraction of the bytes of an
            # 8x one-hot gather over the [B,361,15] planes, and save a
            # full plane pass. chain_id
            # labels are arbitrary-but-consistent representative indices,
            # so permuting positions without remapping values keeps every
            # chain's label unique (liberty counts only compare labels).
            sym = (states.hash[:, 0] % 8).astype(jnp.int32)  # [B]
            ko = states.ko_point
            states = states._replace(
                stones=apply_symmetry_grid_batch(states.stones, sym),
                chain_id=apply_symmetry_grid_batch(states.chain_id, sym),
                last_moves=jax.vmap(apply_symmetry_action)(
                    states.last_moves, sym),
                ko_point=jnp.where(
                    (ko >= 0) & (ko < NUM_LOCS),
                    SYM_SCATTER[sym, jnp.clip(ko, 0, NUM_LOCS - 1)], ko),
            )
            sym_oh = jax.nn.one_hot(sym, NUM_SYMMETRIES)  # [B, 8]
        # Serve planes in the model's compute dtype: every plane value is
        # 0/1 (exact in bf16) and the model casts anyway, so a bf16 model
        # halves the [W,361,15] featurizer HBM stream.
        planes, scalars = batched_features(
            states, include_ladders,
            planes_dtype=getattr(model, "dtype", jnp.float32))
        if serve_apply is not None:
            out = serve_apply(planes, scalars)
        else:
            out = model.apply(variables, planes, scalars, train=False)
        pi_logits = out.pi_logits
        if p_opt_weight > 0.0:
            # Blend in probability space (the reference blends probs, not
            # logits) and go back to log space for the tree.
            w = float(p_opt_weight)
            blend = ((1.0 - w) * jax.nn.softmax(pi_logits, axis=-1)
                     + w * jax.nn.softmax(out.pi_logits_optimistic, axis=-1))
            pi_logits = jnp.log(jnp.maximum(blend, 1e-30))
        if symmetrize:
            board_part = pi_logits[:, :SYM_SCATTER.shape[1]]
            acc_p = jnp.zeros_like(board_part)
            for s in range(NUM_SYMMETRIES):
                acc_p = acc_p + sym_oh[:, s, None] * board_part[:, SYM_SCATTER[s]]
            pi_logits = jnp.concatenate(
                [acc_p, pi_logits[:, SYM_SCATTER.shape[1]:]], axis=1)
        value = out.outcome_probs[:, 1] - out.outcome_probs[:, 0]
        score_est = jnp.sum(out.score_probs * score_values[None, :], axis=-1)
        score_sq = jnp.sum(out.score_probs * score_values[None, :] ** 2, axis=-1)
        return EvalOutput(
            log_priors=jax.nn.log_softmax(pi_logits, axis=-1),
            outcome_value=value,
            score_est=score_est,
            score_var=jnp.maximum(score_sq - score_est**2, 0.0),
            err_est=jnp.sqrt(jnp.maximum(out.q6_err, 0.0)),
        )

    return eval_fn


def uniform_eval_fn(states: GoState) -> EvalOutput:
    """Dummy NN: uniform policy, zero value (tests / benchmarks)."""
    B = states.stones.shape[0]
    return EvalOutput(
        log_priors=jnp.full((B, NUM_MOVES), -jnp.log(float(NUM_MOVES))),
        outcome_value=jnp.zeros((B,)),
        score_est=jnp.zeros((B,)),
        score_var=jnp.zeros((B,)),
    )


_T_TABLE_MAX_DF = 512


def _t_quantile_table(alpha: float, max_df: int = _T_TABLE_MAX_DF):
    """Two-sided Student-t quantiles for df = 1..max_df (ZScore,
    tree.cc:36-39: quantile(complement(t_dist(n-1), alpha/2))). Computed
    host-side at trace time into a constant array."""
    import numpy as _np
    p = 1.0 - alpha / 2.0
    try:
        from scipy.stats import t as _t
        tab = _t.ppf(p, _np.arange(1, max_df + 1))
    except ImportError:  # pragma: no cover - scipy is in the image
        # Cornish-Fisher expansion of t around the normal quantile.
        from statistics import NormalDist
        z = NormalDist().inv_cdf(p)
        df = _np.arange(1, max_df + 1, dtype=_np.float64)
        tab = z + (z**3 + z) / (4.0 * df) \
            + (5 * z**5 + 16 * z**3 + 3 * z) / (96.0 * df**2)
    return jnp.asarray(tab, jnp.float32)


def _can_stop_early(tree: Tree, cand_actions: jnp.ndarray,
                    cand_valid: jnp.ndarray, k_r: int,
                    base_score: jnp.ndarray, ztab: jnp.ndarray,
                    params: "SearchParams") -> jnp.ndarray:
    """Per-board confidence check (can_stop_early, gumbel.cc:326-352).

    A board may end its round when every live candidate's root edge has
    >= 10 visits (kMinEarlyStoppingVisits) and max-UCB of the bottom half
    (by current gumbel+qtransform score) <= max-LCB of the top half.
    CIs are Student-t on edge Q with variance from the child node
    (ConfidenceInterval, tree.cc:41-51; QVar -> VVar, tree.h:133-139).
    Returns bool[B].
    """
    B, N = tree.n.shape
    ca = cand_actions[:, :k_r]  # [B, k]
    valid = cand_valid[:, :k_r]
    oh = jax.nn.one_hot(ca, NUM_MOVES, dtype=jnp.float32)  # [B, k, 362]
    root_en = tree.edge_n[:, 0, :].astype(jnp.float32)  # [B, 362]
    root_ew = tree.edge_w[:, 0, :]
    n_a = jnp.einsum("bka,ba->bk", oh, root_en)
    w_a = jnp.einsum("bka,ba->bk", oh, root_ew)
    q_a = jnp.where(n_a > 0, -(w_a / jnp.maximum(n_a, 1.0)), MIN_Q)
    childp1 = jnp.einsum("bka,ba->bk", oh,
                         (tree.children[:, 0, :] + 1).astype(jnp.float32))
    has_child = childp1 > 0.5
    child_idx = jnp.clip(childp1.astype(jnp.int32) - 1, 0, N - 1)
    ohn = jax.nn.one_hot(child_idx, N, dtype=jnp.float32)  # [B, k, N]
    vvar_sum = jnp.einsum("bkn,bn->bk", ohn, tree.v_var_sum)
    # VVar: node v_var (= v_var_sum / n), kMaxQ when n < 3 (tree.h:126-130).
    qvar = jnp.where(n_a >= 3, vvar_sum / jnp.maximum(n_a, 1.0), MAX_Q)
    # Student-t z at df = n-1 (constant-table one-hot lookup).
    df = jnp.clip(n_a.astype(jnp.int32) - 1, 1, _T_TABLE_MAX_DF)
    z = jnp.einsum("bkt,t->bk",
                   jax.nn.one_hot(df - 1, _T_TABLE_MAX_DF,
                                  dtype=jnp.float32), ztab)
    std = jnp.sqrt(jnp.maximum(qvar, 0.0) / jnp.maximum(n_a, 1.0))
    lcb = q_a - z * std
    ucb = q_a + z * std
    # All live candidates need a child with >= kMinEarlyStoppingVisits.
    ok = jnp.all(~valid | (has_child & (n_a >= 10.0)), axis=1)
    # Partition by current score order (update_qtransform + sort precede
    # the check, gumbel.cc:460-466): top k/2 contribute LCBs, rest UCBs.
    maxn = jnp.max(root_en, axis=-1)
    score_a = jnp.einsum("bka,ba->bk", oh, base_score) \
        + (params.c_visit + maxn[:, None]) * params.c_scale * q_a
    score_a = jnp.where(valid, score_a, _BIG_NEG)
    gt = score_a[:, None, :] > score_a[:, :, None]  # [B, i, j]: s_j > s_i
    eq = score_a[:, None, :] == score_a[:, :, None]
    jlt = (jnp.arange(k_r)[None, :] < jnp.arange(k_r)[:, None])[None]
    rank = jnp.sum((gt | (eq & jlt)).astype(jnp.int32), axis=2)  # [B, k]
    half = k_r // 2
    top = valid & (rank < half)
    bot = valid & (rank >= half)
    top_lcb = jnp.max(jnp.where(top, lcb, -2.0), axis=1)
    bot_ucb = jnp.max(jnp.where(bot, ucb, -2.0), axis=1)
    return ok & (bot_ucb <= top_lcb)


def _score_utility(score_weight, score_est, root_score_signed):
    """Direct-mode score utility (leaf_evaluator.cc:79-82 ScoreTransform)."""
    return score_weight * (2.0 / math.pi) * jnp.arctan(
        (score_est - root_score_signed) / BOARD_LEN)


def _score_utility_integral(score_weight, score_est, score_stddev,
                            root_score_signed):
    """Gaussian-integral score utility (kIntegral mode,
    leaf_evaluator.cc:12-77): E_z[(2/pi) atan((mean + z*sigma)/19)] under a
    truncated standard normal (z in [-5, 5], step 0.1), with the mean
    interpolated between absolute score and advantage
    (mean = score_est - 0.75 * root_score, ScoreTransformIntegral:49-54).
    Computed directly per lane on the VPU instead of bilinearly
    interpolating the reference's precomputed [800, 400] grid (deviation:
    no interpolation error; a per-lane table gather would serialize)."""
    z = jnp.arange(-50, 51, dtype=jnp.float32) * 0.1
    pdf = jnp.exp(-0.5 * z * z)
    mean = score_est - 0.75 * root_score_signed
    vals = jnp.arctan(
        (mean[..., None] + z * score_stddev[..., None]) / BOARD_LEN)
    integral = (2.0 / math.pi) * jnp.sum(vals * pdf, axis=-1) / jnp.sum(pdf)
    return score_weight * integral


def _leaf_score_utility(params, score_est, score_var, root_score_signed):
    """Dispatch on SearchParams.score_utility_mode (ScoreUtility,
    leaf_evaluator.cc:124-131)."""
    if params.score_utility_mode == "integral":
        return _score_utility_integral(
            params.score_weight, score_est,
            jnp.sqrt(jnp.maximum(score_var, 0.0)), root_score_signed)
    return _score_utility(params.score_weight, score_est, root_score_signed)


def _cheap_scores(states: GoState):
    """1-step Tromp-Taylor: stones + empties adjacent to exactly one color.

    Exact on settled terminal positions (every empty region of size 1-2
    bordered by one color); an approximation for premature double-pass
    positions deep in the tree. -> (black, white) [B] each.
    """
    from p3achygo_tpu.game.board import NEIGHBORS, _pad

    def one(stones, komi):
        nbr = _pad(stones, jnp.int8(99))[NEIGHBORS]  # [361, 4]
        empty = stones == 0
        b_adj = jnp.any(nbr == 1, axis=1)
        w_adj = jnp.any(nbr == -1, axis=1)
        b = jnp.sum((stones == 1) | (empty & b_adj & ~w_adj))
        w = jnp.sum((stones == -1) | (empty & w_adj & ~b_adj))
        return b.astype(jnp.float32), w.astype(jnp.float32) + komi

    return jax.vmap(one)(states.stones, states.komi)


def _init_nodes(tree: Tree, node: jnp.ndarray, ev: EvalOutput,
                color: jnp.ndarray, util: jnp.ndarray,
                active: jnp.ndarray, bidx: jnp.ndarray = None) -> Tree:
    """Write NN eval into node slots (InitFields, leaf_evaluator.cc:93-122).

    Inactive rows are routed to the reserved spare slot (last node index) so
    duplicate scatter indices across k-wide lanes can't clobber live writes.
    """
    b = jnp.arange(node.shape[0]) if bidx is None else bidx
    spare = tree.n.shape[1] - 1
    node = jnp.where(active, node, spare)
    sel = lambda new, old: jnp.where(active, new, old)
    err = (ev.err_est if ev.err_est is not None
           else jnp.zeros_like(ev.outcome_value))
    return tree._replace(
        log_priors=tree.log_priors.at[b, node].set(
            jnp.where(active[:, None],
                      ev.log_priors.astype(tree.log_priors.dtype),
                      tree.log_priors[b, node])),
        init_err=tree.init_err.at[b, node].set(
            sel(err, tree.init_err[b, node])),
        init_outcome=tree.init_outcome.at[b, node].set(
            sel(ev.outcome_value, tree.init_outcome[b, node])),
        init_score=tree.init_score.at[b, node].set(
            sel(ev.score_est, tree.init_score[b, node])),
        init_util=tree.init_util.at[b, node].set(
            sel(util, tree.init_util[b, node])),
        color=tree.color.at[b, node].set(
            jnp.where(active, color, tree.color[b, node]).astype(jnp.int8)),
        evaluated=tree.evaluated.at[b, node].set(
            tree.evaluated[b, node] | active),
    )


def _improved_policy_flat(tree: Tree, node: jnp.ndarray,
                          c_visit: float, c_scale: float,
                          bidx: jnp.ndarray = None):
    """Completed-Q improved policy of `node` (ComputeImprovedPolicy,
    gumbel.cc:196-212). -> (pi [W, 362], nvis [W, 362], sum_children [W])."""
    b = jnp.arange(node.shape[0]) if bidx is None else bidx
    B = tree.n.shape[0]
    node_bk = node.reshape(B, -1)
    W = node.shape[0]
    logp = rows_by_node(tree.log_priors, node_bk).reshape(W, -1)
    q, nvis = q_nvis_of_children(tree, node_bk)
    q = q.reshape(W, -1)
    nvis = nvis.reshape(W, -1)
    visited = nvis > 0
    maxn = jnp.max(nvis, axis=-1)
    sum_children = jnp.maximum(tree.n[b, node] - 1, 0).astype(jnp.float32)

    probs = jnp.exp(logp)
    visited_prob = jnp.sum(jnp.where(visited, probs, 0.0), axis=-1)
    weighted_q = jnp.sum(jnp.where(visited, probs * q, 0.0), axis=-1)
    init_util = tree.init_util[b, node]
    v_mix = jnp.where(
        sum_children > 0,
        (weighted_q * sum_children / jnp.maximum(visited_prob, 1e-10)
         + init_util) / (1.0 + sum_children),
        init_util,
    )

    q_scale = jnp.where(maxn > 0, 2.0 * jnp.log(jnp.maximum(maxn, 1).astype(jnp.float32)), 0.0)
    q_norm = (q + 1.5) / 3.0
    v_mix_norm = (v_mix + 1.5) / 3.0
    completed = jnp.where(visited, q_norm, v_mix_norm[:, None])
    logits_improved = logp + ((c_visit + q_scale[:, None]) * c_scale) * completed
    pi = jax.nn.softmax(logits_improved, axis=-1)
    return pi, nvis, sum_children


def _nonroot_action(tree: Tree, node: jnp.ndarray, legal: jnp.ndarray,
                    c_visit: float, c_scale: float,
                    bidx: jnp.ndarray = None) -> jnp.ndarray:
    """Improved-policy-minus-visit-share argmax (gumbel.cc:214-237).

    `node` is [W] with W = B * k (lanes b-major); row-indexed tree state is
    read with one-hot contractions instead of generic per-row gathers.
    """
    pi, nvis, sum_children = _improved_policy_flat(tree, node, c_visit,
                                                   c_scale, bidx)
    disparity = pi - nvis.astype(jnp.float32) / (1.0 + sum_children)[:, None]
    return jnp.argmax(jnp.where(legal, disparity, _BIG_NEG), axis=-1).astype(jnp.int32)


def _grouped_action(tree: Tree, node: jnp.ndarray, legal: jnp.ndarray,
                    c_visit: float, c_scale: float, rank: jnp.ndarray,
                    g: int, bidx: jnp.ndarray) -> jnp.ndarray:
    """Greedy multi-visit apportionment of the disparity rule.

    The reference assigns a round's visits one at a time, each picking
    argmax(pi - n_a / (1 + sum_children)) with the node's counters advanced
    by the previous assignments (gumbel.cc:214-237 applied per visit).
    With FROZEN pi/Q, that sequential assignment is deterministic, so the
    t-th arrival's action is computable in parallel: unroll the g
    assignment steps over a scratch visit-count delta and give each lane
    the action of its arrival `rank` at the node. Exactly _nonroot_action
    when g == 1.
    """
    pi, nvis, sum_children = _improved_policy_flat(tree, node, c_visit,
                                                   c_scale, bidx)
    nvisf = nvis.astype(jnp.float32)
    extra = jnp.zeros_like(pi)
    out = jnp.zeros((node.shape[0],), jnp.int32)
    for t in range(g):
        disparity = pi - (nvisf + extra) \
            / (1.0 + sum_children + float(t))[:, None]
        a_t = jnp.argmax(jnp.where(legal, disparity, _BIG_NEG),
                         axis=-1).astype(jnp.int32)
        out = jnp.where(rank == t, a_t, out)
        if t < g - 1:
            extra = extra + jax.nn.one_hot(a_t, NUM_MOVES, dtype=pi.dtype)
    return out


def _sweep_action_table(tree: Tree, c_visit: float, c_scale: float,
                        g: int, with_transitions: bool = False):
    """[B, N, g] best action per node per within-sweep arrival rank.

    The tree is FROZEN during a sweep's descents (child writes apply after
    the loop), so the action the improved-policy disparity rule picks at
    any node (gumbel.cc:214-237, = _nonroot_action/_grouped_action) depends
    only on that node's stats and the lane's arrival rank t. Computing the
    whole table once per sweep is pure elementwise work over the node
    arrays — edge stats are already edge-indexed, so NO row gathers — and
    it turns the descent while_loop into single-point index reads instead
    of four full [B, N, 362] one-hot contractions per level (the dominant
    search cost at depth > 1).

    With `with_transitions`, additionally returns the full per-(node,
    arrival-rank) descent transition table [B, N, g, 4] with channels
    (child index or -1, action, child-is-terminal, next arrival rank), so
    the descent loop body is ONE one-hot table read per level instead of
    four separate point gathers (tree mode only — under MCGS transposed
    nodes can be shared across candidates and ranks are dynamic).
    """
    nvis = tree.edge_n  # [B, N, A]
    en = nvis.astype(jnp.float32)
    q = jnp.where(nvis > 0, -(tree.edge_w / jnp.maximum(en, 1.0)), MIN_Q)
    logp = tree.log_priors.astype(jnp.float32)
    sum_children = jnp.maximum(tree.n - 1, 0).astype(jnp.float32)  # [B, N]
    maxn = jnp.max(nvis, axis=-1)  # [B, N]
    probs = jnp.exp(logp)
    visited = nvis > 0
    visited_prob = jnp.sum(jnp.where(visited, probs, 0.0), axis=-1)
    weighted_q = jnp.sum(jnp.where(visited, probs * q, 0.0), axis=-1)
    init_util = tree.init_util
    v_mix = jnp.where(
        sum_children > 0,
        (weighted_q * sum_children / jnp.maximum(visited_prob, 1e-10)
         + init_util) / (1.0 + sum_children),
        init_util,
    )
    q_scale = jnp.where(
        maxn > 0,
        2.0 * jnp.log(jnp.maximum(maxn, 1).astype(jnp.float32)), 0.0)
    completed = jnp.where(visited, (q + 1.5) / 3.0,
                          ((v_mix + 1.5) / 3.0)[:, :, None])
    logits_improved = logp \
        + ((c_visit + q_scale[:, :, None]) * c_scale) * completed
    pi = jax.nn.softmax(logits_improved, axis=-1)
    legal = tree.s_legal
    extra = jnp.zeros_like(pi)
    outs = []
    child_ts = []
    term_ts = []
    N = tree.n.shape[1]
    for t in range(g):
        disparity = pi - (en + extra) \
            / (1.0 + sum_children + float(t))[:, :, None]
        a_t = jnp.argmax(jnp.where(legal, disparity, _BIG_NEG),
                         axis=-1).astype(jnp.int32)
        outs.append(a_t)
        if t < g - 1 or with_transitions:
            oh_t = jax.nn.one_hot(a_t, NUM_MOVES, dtype=pi.dtype)
            if t < g - 1:
                extra = extra + oh_t
            if with_transitions:
                # child at (node, t): one-hot row reduce over the action
                # axis (value -1 selects exactly through the one-hot).
                ch_t = jnp.einsum(
                    "bna,bna->bn", oh_t,
                    tree.children.astype(jnp.float32),
                    preferred_element_type=jnp.float32).astype(jnp.int32)
                child_ts.append(ch_t)
                oh_c = jax.nn.one_hot(jnp.clip(ch_t, 0, N - 1), N,
                                      dtype=jnp.float32)
                tm_t = jnp.einsum(
                    "bnm,bm->bn", oh_c,
                    tree.is_terminal.astype(jnp.float32),
                    preferred_element_type=jnp.float32)
                term_ts.append((tm_t > 0.5) & (ch_t >= 0))
    acts = jnp.stack(outs, axis=-1)  # [B, N, g]
    if not with_transitions:
        return acts
    child = jnp.stack(child_ts, axis=-1)  # [B, N, g]
    term = jnp.stack(term_ts, axis=-1)  # [B, N, g] bool
    # next arrival rank: lanes taking the same action from the same node
    # land on the same child; their new ranks enumerate in t order.
    nr = jnp.zeros_like(acts)
    for t in range(1, g):
        same = jnp.stack([acts[:, :, tp] == acts[:, :, t]
                          for tp in range(t)], axis=-1)
        nr = nr.at[:, :, t].set(
            jnp.sum(same, axis=-1).astype(jnp.int32))
    table = jnp.stack([
        child.astype(jnp.float32),
        acts.astype(jnp.float32),
        term.astype(jnp.float32),
        nr.astype(jnp.float32),
    ], axis=-1)  # [B, N, g, 4]
    return acts, table


class RootPreStats(NamedTuple):
    """Pre-search root statistics from a reused tree, feeding sel_mult and
    the .stats pipeline (self_play_thread.cc:459-482)."""

    n_pre: jnp.ndarray  # int32[B] root visits before this search
    q_pre: jnp.ndarray  # f32[B] root mean utility (0 for fresh roots)
    qz_pre: jnp.ndarray  # f32[B] root mean outcome value
    std_pre: jnp.ndarray  # f32[B] sqrt(v_outcome_var), 0 when n_pre < 3
    pre_kld: jnp.ndarray  # f32[B] KLD(improved-policy || prior), 0 if fresh
    nn_q: jnp.ndarray  # f32[B] init_util_est (0 for unevaluated roots)
    qz_nn: jnp.ndarray  # f32[B] init_outcome_est
    nn_mcts_diff: jnp.ndarray  # f32[B] |qz_nn - q_pre|, 0 when n_pre == 0
    q_canonical: jnp.ndarray  # f32[B] qz_pre, falling back to qz_nn
    nn_uncertainty: jnp.ndarray  # f32[B] init_err_est (v_err)
    prior_entropy: jnp.ndarray  # f32[B] H(prior)


def root_pre_stats(tree: Tree, c_visit: float = 50.0,
                   c_scale: float = 1.0) -> RootPreStats:
    """Compute pre-search root stats on a (reused) tree.

    Mirrors the pre-search block of the selfplay loop
    (self_play_thread.cc:459-482): every signal is zero for fresh
    (unevaluated / unvisited) roots, which makes the sel_mult modifier
    collapse to 1 exactly as the reference's null guards do.
    """
    B = tree.n.shape[0]
    root = jnp.zeros((B,), jnp.int32)
    n_pre = tree.n[:, 0]
    nf = jnp.maximum(n_pre, 1).astype(jnp.float32)
    q_pre = jnp.where(n_pre > 0, tree.w[:, 0] / nf, 0.0)
    qz_pre = jnp.where(n_pre > 0, tree.w_outcome[:, 0] / nf, 0.0)
    var_pre = jnp.where(n_pre >= 3, tree.vz_var_sum[:, 0] / nf, 0.0)
    pi_pre, _, _ = _improved_policy_flat(tree, root, c_visit, c_scale)
    priors = jax.nn.softmax(
        tree.log_priors[:, 0, :].astype(jnp.float32), axis=-1)
    eps = 1e-10
    kld = jnp.sum(
        jnp.where(pi_pre > 0,
                  pi_pre * (jnp.log(pi_pre + eps) - jnp.log(priors + eps)),
                  0.0), axis=-1)
    pre_kld = jnp.where(n_pre >= 1, kld, 0.0)
    nn_q = tree.init_util[:, 0]
    qz_nn = tree.init_outcome[:, 0]
    nn_mcts_diff = jnp.where(n_pre > 0, jnp.abs(qz_nn - q_pre), 0.0)
    q_canonical = jnp.where(qz_pre == 0.0, qz_nn, qz_pre)
    entropy = -jnp.sum(jnp.where(priors > 0,
                                 priors * jnp.log(priors + eps), 0.0), axis=-1)
    entropy = jnp.where(tree.evaluated[:, 0], entropy, 0.0)
    return RootPreStats(
        n_pre=n_pre, q_pre=q_pre, qz_pre=qz_pre,
        std_pre=jnp.sqrt(jnp.maximum(var_pre, 0.0)),
        pre_kld=pre_kld, nn_q=nn_q, qz_nn=qz_nn,
        nn_mcts_diff=nn_mcts_diff, q_canonical=q_canonical,
        nn_uncertainty=tree.init_err[:, 0], prior_entropy=entropy)


def search_root(key: jax.Array, states: GoState, eval_fn: EvalFn,
                params: SearchParams,
                tau: Optional[jnp.ndarray] = None,
                init_tree: Optional[Tree] = None,
                reuse_capacity: int = 0,
                bias_table=None):
    """Run sequential-halving Gumbel search on a batch of boards.

    `tau` optionally overrides params.tau with a per-board [B] temperature
    (selfplay decays it with move number, self_play_thread.cc:570-581);
    tau <= 0 rows play the deterministic top candidate.

    Tree reuse: pass `init_tree` (a compacted subtree from the previous
    move, see tree.compact_subtree) and a static `reuse_capacity` > 0;
    reused roots keep their statistics and skip re-initialization
    (EvaluateRoot only for kNew roots, gumbel.cc:275-278) and the call
    returns (result, working_tree). The caller compacts the working tree
    under the move it actually plays (which may differ from
    result.mcts_move after the superko guard / raw-policy opening).
    """
    B = states.stones.shape[0]
    b = jnp.arange(B)
    n, k = params.n, params.k
    num_rounds = max(int(math.log2(k)) if k > 1 else 1, 1)

    # Exact visit schedule (gumbel.cc:388-401): per round r with k_r
    # candidates, v_r = round(n / (num_rounds * k_r)) visits per action.
    schedule = []  # (round, slot) per simulation
    k_r, total_sims = k, 0
    round_specs = []
    max_alloc = 0
    while k_r > 1:
        v_r = int(round(n / (num_rounds * k_r)))
        v_r = max(v_r, 1)
        round_specs.append((k_r, v_r))
        total_sims += v_r * k_r
        # Allocation bound per round: over-search raises the visit budget
        # to 2.5x (gumbel.cc:397-409) and a grouped final sweep can
        # overshoot the budget by up to g-1 visits per candidate; the node
        # arrays must cover the worst case or scatters silently drop
        # (see compact_subtree clamp note).
        budget_r = v_r * 5 // 2 if params.over_search else v_r
        g_r = max(1, min(params.visit_group, v_r))
        over = (g_r - 1) if (params.early_stopping or params.over_search) \
            else 0
        max_alloc += (budget_r + over) * k_r
        k_r //= 2
    theoretical_winner_visits = sum(v for _, v in round_specs)

    max_nodes = max_alloc + 2 + (reuse_capacity if init_tree is not None
                                 else 0)
    tree = make_tree(B, max_nodes)
    if init_tree is not None:
        R = init_tree.n.shape[1]
        splice = {}
        for field in Tree._fields:
            cur = getattr(tree, field)
            src = getattr(init_tree, field)
            if field == "next_free":
                splice[field] = init_tree.next_free
            else:
                splice[field] = cur.at[:, :R].set(src)
        tree = tree._replace(**splice)
        reused = init_tree.evaluated[:, 0]
    else:
        reused = jnp.zeros((B,), jnp.bool_)

    # --- root eval (EvaluateRoot only for kNew roots,
    #     leaf_evaluator.cc:136-154 / gumbel.cc:275-278) ---
    root_ev = eval_fn(states)
    root_color = states.to_move
    tree = _init_nodes(tree, jnp.zeros((B,), jnp.int32), root_ev, root_color,
                       root_ev.outcome_value, ~reused)
    fresh = (~reused).astype(jnp.int32)
    freshf = (~reused).astype(jnp.float32)
    bucket0 = jnp.clip(
        ((root_ev.outcome_value + 1.0) / V_BUCKET_RANGE).astype(jnp.int32),
        0, NUM_V_BUCKETS - 1)
    tree = tree._replace(
        n=tree.n.at[:, 0].set(jnp.where(reused, tree.n[:, 0], 1)),
        w=tree.w.at[:, 0].set(
            jnp.where(reused, tree.w[:, 0], root_ev.outcome_value)),
        w_outcome=tree.w_outcome.at[:, 0].set(
            jnp.where(reused, tree.w_outcome[:, 0], root_ev.outcome_value)),
        score_sum=tree.score_sum.at[:, 0].set(
            jnp.where(reused, tree.score_sum[:, 0], root_ev.score_est)),
        v_categorical=tree.v_categorical.at[b, 0, bucket0].add(fresh),
    )
    root_score_est = jnp.where(reused, tree.init_score[:, 0],
                               root_ev.score_est)

    # --- root candidates: logits + gumbel noise (gumbel.cc:287-306) ---
    legal_plain = jax.vmap(legal_mask)(states)  # [B, 362] (in-tree mask)
    legal0 = legal_plain
    if params.disable_pass:
        has_board_move = jnp.any(legal0[:, :PASS_MOVE], axis=-1)
        legal0 = legal0.at[:, PASS_MOVE].set(
            legal0[:, PASS_MOVE] & ~has_board_move)

    # Store the root board into node 0's state slots (see Tree s_* fields:
    # descents read stored node states instead of replaying moves). Safe
    # to overwrite for reused roots — the compacted subtree's root is by
    # construction the current position.
    tree = tree._replace(
        s_stones=tree.s_stones.at[:, 0].set(states.stones),
        s_chain=tree.s_chain.at[:, 0].set(states.chain_id.astype(jnp.int16)),
        s_last5=tree.s_last5.at[:, 0].set(states.last_moves.astype(jnp.int16)),
        s_ko=tree.s_ko.at[:, 0].set(states.ko_point.astype(jnp.int16)),
        s_cpass=tree.s_cpass.at[:, 0].set(
            states.consecutive_passes.astype(jnp.int8)),
        s_hash=tree.s_hash.at[:, 0].set(states.hash),
        s_legal=tree.s_legal.at[:, 0].set(legal_plain),
    )
    root_log_priors = tree.log_priors[:, 0, :].astype(jnp.float32)
    masked_logp = jnp.where(legal0, root_log_priors, _BIG_NEG)
    key, knoise = jax.random.split(key)
    gnoise = params.noise_scale * jax.random.gumbel(knoise, (B, NUM_MOVES))
    gnoise = jnp.where(legal0, gnoise, 0.0)
    base_score = masked_logp + gnoise

    raw_nn_move = jnp.argmax(root_log_priors, axis=-1).astype(jnp.int32)

    if n <= 1:
        # n == 1: play the gumbel-top LEGAL move (the reference returns
        # gmove_info[0].move_loc, the max of masked logit + noise,
        # gumbel.cc:312-316) — NOT the unmasked raw-policy argmax, which
        # can be an occupied point.
        pi = jax.nn.softmax(masked_logp, axis=-1)
        board_over1 = jax.vmap(is_game_over)(states)
        top_legal = jnp.argmax(base_score, axis=-1).astype(jnp.int32)
        any_legal = jnp.any(legal0, axis=-1)
        mcts_move1 = jnp.where(any_legal & ~board_over1, top_legal, PASS_MOVE)
        result = GumbelResult(
            mcts_move=mcts_move1,
            raw_nn_move=raw_nn_move,
            pi_improved=pi,
            root_value=root_ev.outcome_value,
            root_outcome=root_ev.outcome_value,
            root_score_est=root_score_est,
            q_selected=jnp.full((B,), MIN_Q),
            qz_selected=jnp.full((B,), -1.0),
            kld=jnp.zeros((B,)),
            visits=jnp.zeros((B,), jnp.int32),
            root_child_visits=jnp.zeros((B, NUM_MOVES), jnp.int32),
            root_priors=pi,
            root_value_dist=jnp.zeros((B, NUM_V_BUCKETS), jnp.int32),
            root_child_q=jnp.full((B, NUM_MOVES), MIN_Q),
        )
        # Callers passing init_tree / bias_table expect matching tuples.
        if params.bias_lambda > 0 and bias_table is not None:
            if init_tree is not None:
                return result, tree, bias_table
            return result, bias_table
        if init_tree is not None:
            return result, tree
        return result

    _, cand_actions = jax.lax.top_k(base_score, k)  # [B, k] desc
    cand_actions = cand_actions.astype(jnp.int32)
    cand_valid = jnp.take_along_axis(legal0, cand_actions, axis=1)
    board_over = jax.vmap(is_game_over)(states)

    use_bias = params.bias_lambda > 0 and bias_table is not None

    # --- k-wide visit sweeps, round-width specialized ---
    # The reference visits the k candidates sequentially within each visit
    # round (gumbel.cc:413-446), but candidate subtrees are disjoint and the
    # root takes no stat updates during search, so all k sims of a sweep are
    # independent: run them as one [B*k_r]-wide batched simulation.
    # Sequential sim steps drop from n to sum_r v_r and every NN eval
    # batches B*k_r leaves into one forward. Each halving round is traced at
    # its OWN width W_r = B * k_r (round 2 of n=32,k=4 runs 8 of 12 sweeps
    # with only 2 live candidates — a fixed-width scan would spend ~33%
    # of all W-proportional work on dead lanes).
    spare = max_nodes - 1  # reserved dummy slot for inactive-lane scatters

    def one_sweep(tree, k_r, cand_actions, cand_valid, stopped=None,
                  mcgs=None, group=1):
        """One (k_r*group)-wide visit sweep: every live candidate gets
        `group` sims at once (see SearchParams.visit_group).

        `stopped` [B] marks boards whose round ended early — their lanes
        go inactive (no visits, no tree writes). `mcgs` (McgsTable or
        None) enables graph search: new leaves probe the table and link to
        an existing transposed node instead of allocating; returns
        (tree, mcgs)."""
        L = k_r * group  # lanes per board, candidate-major
        W = B * L
        bw = jnp.arange(W) // L  # board index per lane
        root_color_w = root_color[bw]
        root_score_w = root_score_est[bw]
        # Candidates are rerank-sorted descending, so lanes 0..k_r-1 are
        # the surviving half; constant within a round.
        action0 = jnp.repeat(cand_actions[:, :k_r], group,
                             axis=1).reshape(-1)  # [W]
        valid0 = jnp.repeat(cand_valid[:, :k_r], group,
                            axis=1).reshape(-1) & ~board_over[bw]
        if stopped is not None:
            valid0 = valid0 & ~stopped[bw]
        lane_lt = (jnp.arange(L)[None, :] < jnp.arange(L)[:, None])[None]

        # --- descent (Search, gumbel.cc:674-727), k-wide, stateless ---
        # NO board stepping inside the loop: every node stores its
        # position + legality at creation (Tree s_* fields). And NO tree
        # row reads either: the tree is frozen for the whole sweep, so the
        # disparity-rule action of every node per arrival rank is
        # precomputed ONCE (act_table below) and a level is just
        # single-point index reads. The single board step per sweep
        # happens after the loop at the leaf.
        D = params.max_depth
        path_nodes0 = jnp.full((W, D), -1, jnp.int32)
        lane = jnp.arange(W)
        NEW_MARK = jnp.int32(-2)  # placeholder for this sweep's new node

        if mcgs is None:
            # Tree mode: gather-free descent. The whole per-(node,
            # arrival-rank) transition (child, action, terminal, next
            # rank) is precomputed once per sweep, level 0 (the candidate
            # edge from the root) is resolved before the loop, and each
            # loop level is ONE one-hot table read + a one-hot-depth path
            # write — per-lane point gathers/scatters cost a full kernel
            # launch each at lane width and dominated the sweep
            # (benchmarks/micro_descent_ops.py).
            act_table, trans = _sweep_action_table(
                tree, params.c_visit, params.c_scale, group,
                with_transitions=True)
            trans_flat = trans.reshape(B, max_nodes, 4 * group)

            # --- level 0: follow the candidate action out of the root ---
            oh_a0 = jax.nn.one_hot(action0.reshape(B, L), NUM_MOVES,
                                   dtype=jnp.float32)
            child0 = jnp.einsum(
                "bla,ba->bl", oh_a0,
                tree.children[:, 0, :].astype(jnp.float32),
                preferred_element_type=jnp.float32
            ).reshape(-1).astype(jnp.int32)
            oh_c0 = jax.nn.one_hot(
                jnp.clip(child0, 0, max_nodes - 1).reshape(B, L),
                max_nodes, dtype=jnp.float32)
            term0 = (jnp.einsum(
                "bln,bn->bl", oh_c0, tree.is_terminal.astype(jnp.float32),
                preferred_element_type=jnp.float32).reshape(-1) > 0.5) \
                & (child0 >= 0)
            need0 = (child0 < 0) & valid0
            child_idx0 = jnp.where(valid0,
                                   jnp.where(need0, NEW_MARK, child0), 0)
            path_nodes = path_nodes0.at[:, 0].set(
                jnp.where(valid0, child_idx0, -1))
            path_actions = jnp.zeros((W, D), jnp.int32).at[:, 0].set(
                jnp.where(valid0, action0, 0))
            alloc_parent0 = jnp.where(need0, 0, spare).astype(jnp.int32)
            alloc_action0 = jnp.where(need0, action0, 0)
            done0 = ~valid0 | need0 | term0
            # Replicas of one candidate are lane-contiguous: arrival rank
            # at the shared root child is the replica index.
            rank0 = (jnp.arange(W) % group).astype(jnp.int32)
            depth0 = jnp.where(valid0, 1, 0)

            def body(carry):
                (cur, rank, depth, done, path_nodes, path_actions,
                 alloc_parent, alloc_action) = carry
                active = ~done
                node_c = jnp.clip(cur, 0, max_nodes - 1)
                ohn = jax.nn.one_hot(node_c.reshape(B, L), max_nodes,
                                     dtype=jnp.float32)
                row = jnp.einsum("bln,bnc->blc", ohn, trans_flat,
                                 preferred_element_type=jnp.float32)
                if group == 1:
                    sel = row.reshape(W, 4)
                    new_rank = rank
                else:
                    row = row.reshape(W, group, 4)
                    ohr = jax.nn.one_hot(jnp.clip(rank, 0, group - 1),
                                         group, dtype=jnp.float32)
                    sel = jnp.einsum("wg,wgc->wc", ohr, row)
                    new_rank = sel[:, 3].astype(jnp.int32)
                child = sel[:, 0].astype(jnp.int32)
                a = sel[:, 1].astype(jnp.int32)
                term = sel[:, 2] > 0.5
                need_alloc = (child < 0) & active
                child_idx = jnp.where(need_alloc, NEW_MARK, child)
                alloc_parent = jnp.where(need_alloc, node_c, alloc_parent)
                alloc_action = jnp.where(need_alloc, a, alloc_action)
                stop = (need_alloc | term) & active
                wr = jax.nn.one_hot(depth, D, dtype=jnp.bool_) \
                    & active[:, None]
                path_nodes = jnp.where(wr, child_idx[:, None], path_nodes)
                path_actions = jnp.where(wr, a[:, None], path_actions)
                cur = jnp.where(active, child_idx, cur)
                rank = jnp.where(active, new_rank, rank)
                depth = depth + active.astype(jnp.int32)
                done = done | stop | (depth >= D)
                return (cur, rank, depth, done, path_nodes, path_actions,
                        alloc_parent, alloc_action)

            def cond(carry):
                return ~jnp.all(carry[3])

            init = (child_idx0, rank0, depth0, done0, path_nodes,
                    path_actions, alloc_parent0, alloc_action0)
            (cur_final, _, _, _, path_nodes, path_actions, alloc_parent,
             alloc_action) = jax.lax.while_loop(cond, body, init)
        else:
            act_table = _sweep_action_table(
                tree, params.c_visit, params.c_scale, group)  # [B, N, g]

            def body(carry):
                (cur, depth, done, path_nodes, path_actions,
                 alloc_parent, alloc_action) = carry
                active = ~done
                node = cur  # parent for this edge; depth 0 => root(0)
                node_c = jnp.clip(node, 0, max_nodes - 1)
                if group == 1:
                    a_policy = act_table[bw, node_c, 0]
                else:
                    # Arrival rank among this board's ACTIVE lanes at the
                    # same node (a transposed MCGS node CAN be shared
                    # across candidates, where ranks >= group keep the
                    # pre-table behavior of action 0).
                    nodeb = node.reshape(B, L)
                    actb = active.reshape(B, L)
                    eq = (nodeb[:, :, None] == nodeb[:, None, :]) \
                        & actb[:, :, None] & actb[:, None, :]
                    rank = jnp.sum(eq & lane_lt, axis=2).reshape(-1)
                    a_pick = act_table[bw, node_c,
                                       jnp.clip(rank, 0, group - 1)]
                    a_policy = jnp.where(rank < group, a_pick, 0)
                a = jnp.where(depth == 0, action0, a_policy)

                child = tree.children[bw, node, a]
                need_alloc = (child < 0) & active
                child_idx = jnp.where(need_alloc, NEW_MARK,
                                      child).astype(jnp.int32)
                alloc_parent = jnp.where(need_alloc, node, alloc_parent)
                alloc_action = jnp.where(need_alloc, a, alloc_action)

                known_terminal = (child >= 0) & tree.is_terminal[
                    bw, jnp.clip(child_idx, 0, max_nodes - 1)]
                stop = (need_alloc | known_terminal) & active

                path_nodes = path_nodes.at[lane, depth].set(
                    jnp.where(active, child_idx, path_nodes[lane, depth]))
                path_actions = path_actions.at[lane, depth].set(
                    jnp.where(active, a, path_actions[lane, depth]))
                cur = jnp.where(active, child_idx, cur)
                depth = depth + active.astype(jnp.int32)
                done = done | stop | (depth >= D)
                return (cur, depth, done, path_nodes, path_actions,
                        alloc_parent, alloc_action)

            def cond(carry):
                done = carry[2]
                return ~jnp.all(done)

            init = (jnp.zeros((W,), jnp.int32), jnp.zeros((W,), jnp.int32),
                    ~valid0, path_nodes0, jnp.zeros((W, D), jnp.int32),
                    jnp.full((W,), spare, jnp.int32),
                    jnp.zeros((W,), jnp.int32))
            (cur_final, _, _, path_nodes, path_actions, alloc_parent,
             alloc_action) = jax.lax.while_loop(cond, body, init)

        # --- leaf board: gather the alloc parent's stored position
        # (one-hot row reads; uint32 hashes via exact 16-bit halves) and
        # play the chosen action — ONE board step per sweep ---
        want = (cur_final == NEW_MARK) & valid0
        par_sel = jnp.where(want, alloc_parent, 0).reshape(B, L)
        oh_par = jax.nn.one_hot(par_sel, max_nodes, dtype=jnp.float32)
        g_f = lambda arr: jnp.einsum(
            "bln,bn->bl", oh_par, arr.astype(jnp.float32),
            preferred_element_type=jnp.float32).reshape(-1)
        g_fx = lambda arr: jnp.einsum(
            "bln,bnx->blx", oh_par, arr.astype(jnp.float32),
            preferred_element_type=jnp.float32).reshape(W, arr.shape[-1])
        gu32 = lambda arr: (
            (g_fx((arr >> jnp.uint32(16)).astype(jnp.int32))
             .astype(jnp.uint32) << jnp.uint32(16))
            | g_fx((arr & jnp.uint32(0xFFFF)).astype(jnp.int32))
            .astype(jnp.uint32))
        zi32 = jnp.zeros((W,), jnp.int32)
        par_state = GoState(
            stones=g_fx(tree.s_stones).astype(jnp.int8),
            chain_id=g_fx(tree.s_chain).astype(jnp.int32),
            hash=gu32(tree.s_hash),
            history=jnp.zeros((W, 0, 2), jnp.uint32),
            history_len=zi32,
            last_moves=g_fx(tree.s_last5).astype(jnp.int32),
            to_move=g_f(tree.color).astype(jnp.int8),
            ko_point=g_f(tree.s_ko).astype(jnp.int32),
            consecutive_passes=g_f(tree.s_cpass).astype(jnp.int32),
            passes=zi32,
            move_count=zi32,
            komi=jnp.repeat(states.komi, L, axis=0),
            num_b_prisoners=zi32,
            num_w_prisoners=zi32,
            pass_alive=jnp.repeat(states.pass_alive, L, axis=0),
            pa_move=zi32,
        )
        leaf_action = jnp.where(want, alloc_action, jnp.int32(PASS_MOVE))
        leaf_states, _ = jax.vmap(step)(par_state, leaf_action)
        leaf_terminal = jax.vmap(is_game_over)(leaf_states) & want
        leaf_new = want & ~leaf_terminal
        leaf_legal = legal_mask_batch(leaf_states)

        # Assign node slots for this sweep's allocations (<= 1 per lane)
        # and apply the deferred child-table writes in one scatter. Under
        # MCGS, lanes whose new position already exists in the table link
        # to the existing node instead (GetOrCreate, node_table.h:88-101).
        if mcgs is not None:
            meta_q = mcgs_meta(leaf_states.to_move, leaf_terminal)
            hit, hit_node, ins_slot, has_empty = mcgs_probe(
                mcgs, L, leaf_states.hash[:, 0], leaf_states.hash[:, 1],
                meta_q)
            hit = hit & want
        else:
            hit = jnp.zeros_like(want)
            hit_node = jnp.zeros((W,), jnp.int32)
        if group > 1:
            # Grouped replicas stopping at the same unexpanded (parent,
            # action) must share ONE node: the first such lane (leader)
            # allocates; the rest adopt its slot (the reference's visit 1
            # creates the child, visits 2..g land on it as leaf visits).
            keyv = alloc_parent * NUM_MOVES + alloc_action
            keyb = keyv.reshape(B, L)
            wantb = want.reshape(B, L)
            eqk = (keyb[:, :, None] == keyb[:, None, :]) \
                & wantb[:, :, None] & wantb[:, None, :]
            leader_rank = jnp.sum(eqk & lane_lt, axis=2).reshape(-1)
            is_leader = want & (leader_rank == 0)
        else:
            is_leader = want
        allocated = is_leader & ~hit
        na = allocated.reshape(B, L)
        arank = jnp.cumsum(na, axis=1) - na
        new_idx = (tree.next_free[:, None]
                   + arank).reshape(-1).astype(jnp.int32)
        leaf_sub = jnp.where(hit, hit_node, new_idx)
        if group > 1:
            # Followers adopt their leader's resolved node (first matching
            # lane; one-hot gather over the small lane axis).
            lead_idx = jnp.argmax(eqk, axis=2)  # [B, L] first True
            oh_lead = jax.nn.one_hot(lead_idx, L, dtype=jnp.float32)
            gat = lambda v: jnp.einsum(
                "blj,bj->bl", oh_lead,
                v.reshape(B, L).astype(jnp.float32)).reshape(-1)
            leaf_sub = jnp.where(want, gat(leaf_sub).astype(jnp.int32),
                                 leaf_sub)
            hit = jnp.where(want, gat(hit) > 0.5, hit)
        leaf_node = jnp.where(want, leaf_sub,
                              jnp.clip(cur_final, 0, max_nodes - 1))
        path_nodes = jnp.where(path_nodes == NEW_MARK, leaf_sub[:, None],
                               path_nodes)
        link = want | hit  # every want lane links its (parent, action) edge
        wp = jnp.where(link, alloc_parent, spare)
        wa = jnp.where(link, alloc_action, 0)
        ln_routed = jnp.where(allocated, leaf_node, spare)
        tree = tree._replace(
            children=tree.children.at[bw, wp, wa].set(
                jnp.where(link, leaf_node,
                          tree.children[bw, wp, wa].astype(jnp.int32))
                .astype(tree.children.dtype)),
            # Shared nodes keep their first allocation parent (compaction
            # reachability is a tree over first-parents).
            parent=tree.parent.at[bw, ln_routed].set(
                jnp.where(allocated, alloc_parent, tree.parent[bw, ln_routed])),
            parent_action=tree.parent_action.at[bw, ln_routed].set(
                jnp.where(allocated, alloc_action,
                          tree.parent_action[bw, ln_routed])),
            next_free=tree.next_free + jnp.sum(na, axis=1),
            # Store the new node's board state (read by future descents).
            s_stones=tree.s_stones.at[bw, ln_routed].set(
                jnp.where(allocated[:, None], leaf_states.stones,
                          tree.s_stones[bw, ln_routed])),
            s_chain=tree.s_chain.at[bw, ln_routed].set(
                jnp.where(allocated[:, None],
                          leaf_states.chain_id.astype(jnp.int16),
                          tree.s_chain[bw, ln_routed])),
            s_last5=tree.s_last5.at[bw, ln_routed].set(
                jnp.where(allocated[:, None],
                          leaf_states.last_moves.astype(jnp.int16),
                          tree.s_last5[bw, ln_routed])),
            s_ko=tree.s_ko.at[bw, ln_routed].set(
                jnp.where(allocated, leaf_states.ko_point.astype(jnp.int16),
                          tree.s_ko[bw, ln_routed])),
            s_cpass=tree.s_cpass.at[bw, ln_routed].set(
                jnp.where(allocated,
                          leaf_states.consecutive_passes.astype(jnp.int8),
                          tree.s_cpass[bw, ln_routed])),
            s_hash=tree.s_hash.at[bw, ln_routed].set(
                jnp.where(allocated[:, None], leaf_states.hash,
                          tree.s_hash[bw, ln_routed])),
            s_legal=tree.s_legal.at[bw, ln_routed].set(
                jnp.where(allocated[:, None], leaf_legal,
                          tree.s_legal[bw, ln_routed])),
        )
        if mcgs is not None:
            mcgs = mcgs_insert(mcgs, L, ins_slot,
                               leaf_states.hash[:, 0],
                               leaf_states.hash[:, 1], meta_q, new_idx,
                               allocated & has_empty)

        leaf_color = leaf_states.to_move
        root_sign = jnp.where(leaf_color == root_color_w, 1.0, -1.0)

        # --- leaf evaluation (one [B*k] NN call) ---
        # MCGS hits keep the shared node's existing eval (kNew-only init).
        ev = eval_fn(leaf_states)
        util = ev.outcome_value + _leaf_score_utility(
            params, ev.score_est, ev.score_var, root_sign * root_score_w)
        eval_active = leaf_new & valid0 & ~hit
        if use_bias:
            # Local-pattern value correction: q_nn - lambda * bias
            # (bias_cache.h Fetch; applied where the reference's
            # idempotent recompute subtracts obs_bias). The pattern slot
            # is remembered on the node for end-of-search accumulation.
            from p3achygo_tpu.mcts.bias import bias_probe, local_pattern_keys
            libs = point_liberties_batch(leaf_states.stones,
                                         leaf_states.chain_id)
            atari = libs == 1
            ill_empty = (leaf_states.stones == 0) & ~leaf_legal[:, :361]
            bh0, bh1, bvalid = local_pattern_keys(
                leaf_states.stones, atari, ill_empty,
                leaf_states.last_moves, leaf_states.to_move)
            bnum, bden, bslot, bcan = bias_probe(bias_table, L, bh0, bh1,
                                                 bvalid)
            corr = jnp.where(bden > 0,
                             params.bias_lambda * bnum
                             / jnp.maximum(bden, 1e-9), 0.0)
            util = util - corr
            slot_val = jnp.where(bcan, bslot, -1)
            wr_b = eval_active
            tree = tree._replace(
                bias_slot=tree.bias_slot.at[bw, ln_routed].set(
                    jnp.where(wr_b, slot_val, tree.bias_slot[bw, ln_routed])),
                bias_k0=tree.bias_k0.at[bw, ln_routed].set(
                    jnp.where(wr_b, bh0, tree.bias_k0[bw, ln_routed])),
                bias_k1=tree.bias_k1.at[bw, ln_routed].set(
                    jnp.where(wr_b, bh1, tree.bias_k1[bw, ln_routed])),
            )
        tree = _init_nodes(tree, leaf_node, ev, leaf_color, util, eval_active,
                           bw)

        # --- terminal evaluation (EvaluateTerminal, leaf_evaluator.cc:157-188)
        def with_terminal(tree):
            if params.terminal_mode == "exact":
                bs, ws, _ = jax.vmap(score_board)(leaf_states)
            else:
                bs, ws = _cheap_scores(leaf_states)
            player = jnp.where(leaf_color == BLACK, bs, ws)
            oppv = jnp.where(leaf_color == BLACK, ws, bs)
            final_score = player - oppv
            emp_out = jnp.where(player > oppv, 1.0, -1.0)
            # Terminal utility uses stddev 0 (EvaluateTerminal,
            # leaf_evaluator.cc:177-180).
            emp_q = emp_out + _leaf_score_utility(
                params, final_score, jnp.zeros_like(final_score),
                root_sign * root_score_w)
            t_active = leaf_terminal & valid0 \
                & ~tree.is_terminal[bw, leaf_node]
            ln = jnp.where(t_active, leaf_node, spare)
            sel = lambda new, old: jnp.where(t_active, new, old)
            return tree._replace(
                init_util=tree.init_util.at[bw, ln].set(
                    sel(emp_q, tree.init_util[bw, ln])),
                init_outcome=tree.init_outcome.at[bw, ln].set(
                    sel(emp_out, tree.init_outcome[bw, ln])),
                init_score=tree.init_score.at[bw, ln].set(
                    sel(final_score, tree.init_score[bw, ln])),
                color=tree.color.at[bw, ln].set(
                    jnp.where(t_active, leaf_color,
                              tree.color[bw, ln]).astype(jnp.int8)),
                is_terminal=tree.is_terminal.at[bw, ln].set(
                    tree.is_terminal[bw, ln] | t_active),
                evaluated=tree.evaluated.at[bw, ln].set(
                    tree.evaluated[bw, ln] | t_active),
            )

        if params.terminal_mode == "exact":
            # Full scoring is a large subgraph; only execute when some sim
            # actually reached a finished game.
            tree = jax.lax.cond(jnp.any(leaf_terminal & valid0), with_terminal,
                                lambda t: t, tree)
        else:
            tree = with_terminal(tree)

        # --- backprop (Backward, gumbel.cc:738-761) ---
        leaf_q = tree.init_util[bw, leaf_node]
        leaf_qz = tree.init_outcome[bw, leaf_node]
        leaf_score = tree.init_score[bw, leaf_node]
        leaf_c = tree.color[bw, leaf_node]

        # Path nodes are distinct within a sim AND across the k lanes of a
        # board (disjoint subtrees), so the whole sweep's backup is ONE
        # batched scatter over [W, D]; off-path entries add zeros.
        bD = bw[:, None]  # [W, 1]
        nodes = path_nodes  # [W, D]
        on_path = (nodes >= 0) & valid0[:, None]
        node_s = jnp.clip(nodes, 0, max_nodes - 1)
        sign = jnp.where(tree.color[bD, node_s] == leaf_c[:, None], 1.0, -1.0)
        is_leaf_slot = nodes == leaf_node[:, None]
        q = sign * leaf_q[:, None]
        qz = sign * leaf_qz[:, None]
        sc = sign * leaf_score[:, None]
        # Leaf nodes keep v == init (SingleBackup is_leaf branch,
        # gumbel.cc:763-771): add init each visit so w/n == init.
        add_w = jnp.where(is_leaf_slot, tree.init_util[bD, node_s], q)
        add_wz = jnp.where(is_leaf_slot, tree.init_outcome[bD, node_s], qz)
        add_sc = jnp.where(is_leaf_slot, tree.init_score[bD, node_s], sc)
        n_old = tree.n[bD, node_s].astype(jnp.float32)
        inc = on_path.astype(jnp.int32)
        n_new = n_old + inc
        v_old = jnp.where(n_old > 0,
                          tree.w[bD, node_s] / jnp.maximum(n_old, 1),
                          tree.init_util[bD, node_s])
        w_new = tree.w[bD, node_s] + jnp.where(on_path, add_w, 0.0)
        v_new = w_new / jnp.maximum(n_new, 1)
        dvar = (q - v_old) * (q - v_new)
        # Outcome-value Welford increment (v_outcome_var, gumbel.cc:802-806).
        vz_old = jnp.where(n_old > 0,
                           tree.w_outcome[bD, node_s] / jnp.maximum(n_old, 1),
                           tree.init_outcome[bD, node_s])
        wz_new = tree.w_outcome[bD, node_s] + jnp.where(on_path, add_wz, 0.0)
        vz_new = wz_new / jnp.maximum(n_new, 1)
        dvar_z = (qz - vz_old) * (qz - vz_new)
        # Third-moment increment (v_m3, tree.h:46): Pébay update matching
        # the Welford dvar above; m2_old read before this sweep's update.
        dm3 = welford_m3_delta(q, v_old, n_new,
                               tree.v_var_sum[bD, node_s], dvar)
        bucket = jnp.clip(((qz + 1.0) / V_BUCKET_RANGE).astype(jnp.int32), 0,
                          NUM_V_BUCKETS - 1)
        nonleaf = on_path & ~is_leaf_slot
        # One-hot contraction instead of a batched multi-index scatter-add:
        # a small matmul. All L*D
        # path entries of a board fold into one [I, max_nodes] one-hot,
        # read ONCE for all seven node statistics (n/w/wz/score/var/varz +
        # the 51-bucket histogram) via a stacked [B, I, 57] value tensor —
        # per-stat einsums would re-read the ~150MB one-hot each time.
        I = L * D
        oh = jax.nn.one_hot(node_s.reshape(B, I), max_nodes,
                            dtype=jnp.float32)  # [B, I, N]
        onp = on_path.reshape(B, I).astype(jnp.float32)
        nlf = nonleaf.reshape(B, I).astype(jnp.float32)
        oh_bucket = jax.nn.one_hot(bucket.reshape(B, I), NUM_V_BUCKETS,
                                   dtype=jnp.float32)
        stacked = jnp.concatenate([
            jnp.stack([
                onp,
                add_w.reshape(B, I) * onp,
                add_wz.reshape(B, I) * onp,
                add_sc.reshape(B, I) * onp,
                dvar.reshape(B, I) * nlf,
                dvar_z.reshape(B, I) * nlf,
                dm3.reshape(B, I) * nlf,
            ], axis=-1),
            oh_bucket * nlf[:, :, None],
        ], axis=-1)  # [B, I, 7 + 51]
        deltas = jnp.einsum("bif,bin->bnf", stacked, oh,
                            preferred_element_type=jnp.float32)
        d_n, d_w, d_wz, d_sc, d_var, d_varz, d_m3 = (deltas[..., i]
                                                     for i in range(7))
        cat_add = deltas[..., 7:]

        # Edge-stat updates: the edge (parent, action) accumulates the same
        # increments as its child node (tree mode: edge stats == child
        # stats), enabling gather-free child reads during descent. In tree
        # mode every node has ONE incoming edge (parent, parent_action),
        # so the edge updates are the node deltas scattered by the parent
        # table — [B, N(, N|362)] one-hots instead of the 4x bigger
        # [B, I, .] pair. Under MCGS (multi-parent nodes) the delta must
        # follow the edge actually traversed: fall back to path one-hots.
        if mcgs is None:
            par_valid = tree.parent >= 0  # root/unset rows route to zero
            oh_pm = jax.nn.one_hot(
                jnp.where(par_valid, tree.parent, max_nodes), max_nodes,
                dtype=jnp.float32)  # [B, N(child), N(parent)]
            oh_am = jax.nn.one_hot(tree.parent_action, NUM_MOVES,
                                   dtype=jnp.float32)  # [B, N, 362]
            edge_delta = lambda dv: jnp.einsum(
                "bmn,bma->bna", oh_pm * dv[:, :, None], oh_am,
                preferred_element_type=jnp.float32)
            e_n, e_w, e_wz = (edge_delta(d_n), edge_delta(d_w),
                              edge_delta(d_wz))
        else:
            parents = jnp.concatenate(
                [jnp.zeros((W, 1), jnp.int32), node_s[:, :-1]], axis=1)
            oh_parent = jax.nn.one_hot(parents.reshape(B, I), max_nodes,
                                       dtype=jnp.float32)
            oh_act = jax.nn.one_hot(path_actions.reshape(B, I), NUM_MOVES,
                                    dtype=jnp.float32)
            edge = lambda vals, m: jnp.einsum(
                "bin,bia->bna",
                oh_parent * (vals.reshape(B, I) * m)[:, :, None],
                oh_act, preferred_element_type=jnp.float32)
            e_n = edge(inc.astype(jnp.float32), onp)
            e_w = edge(add_w, onp)
            e_wz = edge(add_wz, onp)
        tree = tree._replace(
            n=tree.n + d_n.astype(jnp.int32),
            w=tree.w + d_w,
            w_outcome=tree.w_outcome + d_wz,
            score_sum=tree.score_sum + d_sc,
            v_var_sum=tree.v_var_sum + d_var,
            vz_var_sum=tree.vz_var_sum + d_varz,
            v_m3_sum=tree.v_m3_sum + d_m3,
            v_categorical=tree.v_categorical + cat_add.astype(jnp.int32),
            edge_n=saturating_edge_add(tree.edge_n, e_n),
            edge_w=tree.edge_w + e_w,
            edge_wz=tree.edge_wz + e_wz,
        )

        return tree, mcgs

    def rerank(tree, cand_actions, cand_valid, k_r):
        """Candidate re-ranking at a round boundary (update_qtransform +
        sort, gumbel.cc:355-366,469-471): only the finishing round's top
        k_r lanes compete; the rest sort below them."""
        q0 = q_of_children(tree, jnp.zeros((B,), jnp.int32))
        nvis0 = child_visits(tree, jnp.zeros((B,), jnp.int32))
        maxn = jnp.max(nvis0, axis=-1).astype(jnp.float32)
        qtransform = (params.c_visit + maxn[:, None]) * params.c_scale * q0
        cand_scores = jnp.take_along_axis(base_score + qtransform,
                                          cand_actions, axis=1)
        cand_scores = jnp.where(cand_valid, cand_scores, _BIG_NEG)
        in_round = jnp.arange(k)[None, :] < k_r
        cand_scores = jnp.where(in_round, cand_scores, _BIG_NEG)
        order = jnp.argsort(-cand_scores, axis=1)
        return (jnp.take_along_axis(cand_actions, order, axis=1),
                jnp.take_along_axis(cand_valid, order, axis=1))

    # Run the halving schedule: one scan of v_r sweeps per round, each
    # traced at its own width W_r = B * k_r, with a rerank at every round
    # boundary. Without early stopping, visits accounting is static per
    # round: every live lane spends exactly v_r sims. With early stopping
    # (or over-search) the scan becomes a while_loop that exits as soon as
    # every board has passed its confidence check (per-board semantics:
    # a stopped board's lanes idle; whole-batch exit once all stop).
    es_enabled = params.early_stopping or params.over_search
    if es_enabled:
        lam = params.search_confidence ** (1.0 / num_rounds)
    if params.use_mcgs:
        # Table sized ~2x the node budget (power of two) and seeded with
        # the root (GetOrCreate at search entry, gumbel.cc:426).
        s_tab = 64
        while s_tab < 2 * max_nodes:
            s_tab *= 2
        mcgs = make_mcgs_table(B, s_tab)
        meta_r = mcgs_meta(states.to_move, board_over)
        _, _, slot_r, has_r = mcgs_probe(mcgs, 1, states.hash[:, 0],
                                         states.hash[:, 1], meta_r)
        mcgs = mcgs_insert(mcgs, 1, slot_r, states.hash[:, 0],
                           states.hash[:, 1], meta_r,
                           jnp.zeros((B,), jnp.int32), has_r)
    else:
        mcgs = None
    visits_spent = jnp.zeros((B,), jnp.int32)
    for k_r, v_r in round_specs:
        live_k = cand_valid[:, :k_r] & ~board_over[:, None]  # [B, k_r]
        # Grouped visits: ceil(v_r / g) sweeps, each running g (or the
        # remainder) visits per candidate at once; total per-candidate
        # visits stay exactly v_r (SearchParams.visit_group).
        g = max(1, min(params.visit_group, v_r))
        full, rem = divmod(v_r, g)
        sweep_plan = [(g, full)] + ([(rem, 1)] if rem else [])
        if not es_enabled:
            for g_i, reps in sweep_plan:
                body = (lambda k_r, ca, cv, g_i:
                        lambda c, _: (one_sweep(c[0], k_r, ca, cv,
                                                mcgs=c[1], group=g_i),
                                      None))(k_r, cand_actions, cand_valid,
                                             g_i)
                (tree, mcgs), _ = jax.lax.scan(body, (tree, mcgs), None,
                                               length=reps)
            visits_spent = visits_spent + v_r * jnp.sum(
                live_k.astype(jnp.int32), axis=1)
        else:
            # (visits_per_action, check_interval, min_check),
            # gumbel.cc:397-409. The reference checks at 0-indexed
            # visit_num with visit_num % c == c-1 and
            # visit_num >= min_check; here i counts VISITS (grouped sweeps
            # advance it by their group size g) and checks run at the
            # first sweep boundary past each reference check point.
            if params.over_search:
                budget = v_r * 5 // 2
                c = -(-v_r // 4)
                first_check = v_r
            else:
                budget = v_r
                c = -(-v_r // 4)
                first_check = c
            kb = k_r // 2 + k_r % 2
            ztab = _t_quantile_table(lam / kb)
            dead = ~jnp.any(live_k, axis=1)  # [B] no live lane this round

            def es_cond(carry, budget=budget):
                _, _, stopped, i, _, _ = carry
                return (i < budget) & ~jnp.all(stopped | dead)

            def es_body(carry, k_r=k_r, c=c, first_check=first_check,
                        ca=cand_actions, cv=cand_valid, ztab=ztab,
                        live_k=live_k, g=g):
                tree, mcgs, stopped, i, prev, vs = carry
                tree, mcgs = one_sweep(tree, k_r, ca, cv, stopped,
                                       mcgs=mcgs, group=g)
                vs = vs + g * jnp.sum(
                    (live_k & ~stopped[:, None]).astype(jnp.int32), axis=1)
                i = i + g
                is_check = (i >= first_check) & ((i // c) > (prev // c))
                stop_now = _can_stop_early(tree, ca, cv, k_r, base_score,
                                           ztab, params)
                stopped = stopped | (is_check & stop_now)
                return tree, mcgs, stopped, i, i, vs

            tree, mcgs, _, _, _, visits_spent = jax.lax.while_loop(
                es_cond, es_body,
                (tree, mcgs, jnp.zeros((B,), jnp.bool_), jnp.int32(0),
                 jnp.int32(0), visits_spent))
        cand_actions, cand_valid = rerank(tree, cand_actions, cand_valid, k_r)

    # --- final improved policy (ComputeRootImprovedPolicy, gumbel.cc:154-175)
    q0 = q_of_children(tree, jnp.zeros((B,), jnp.int32))
    nvis0 = child_visits(tree, jnp.zeros((B,), jnp.int32))
    probs0 = jax.nn.softmax(masked_logp, axis=-1)
    # Reference parity: root->n is still 1 when ComputeRootImprovedPolicy
    # runs (stitching happens after), so VMixed(root) short-circuits to
    # init_util_est (gumbel.cc:68-72,477-480).
    v_mix = tree.init_util[:, 0]
    visit_advantage = 2.0 * math.log(theoretical_winner_visits + 1.0)
    q_norm = (q0 + 1.1) / 2.2
    v_mix_norm = (v_mix + 1.1) / 2.2
    completed = jnp.where(nvis0 > 0, q_norm, v_mix_norm[:, None])
    logits_improved = masked_logp + (params.c_visit + visit_advantage) \
        * params.c_scale * completed
    pi_improved = jax.nn.softmax(logits_improved, axis=-1)

    # --- move selection ---
    top_candidate = cand_actions[:, 0]
    if tau is None:
        tau_arr = jnp.full((B,), params.tau, jnp.float32)
        use_sampling = params.tau > 0.0
    else:
        tau_arr = tau.astype(jnp.float32)
        use_sampling = True
    if use_sampling:
        key, ksample = jax.random.split(key)
        safe_tau = jnp.maximum(tau_arr, 1e-3)[:, None]
        tempered_logits = jnp.where(
            pi_improved > 0,
            jnp.log(jnp.maximum(pi_improved, 1e-30)) / safe_tau, _BIG_NEG)
        sampled = jax.random.categorical(ksample, tempered_logits,
                                         axis=-1).astype(jnp.int32)
        mcts_move = jnp.where(tau_arr > 0, sampled,
                              top_candidate.astype(jnp.int32))
    else:
        mcts_move = top_candidate.astype(jnp.int32)
    # Boards with no valid candidate (terminal / all illegal) pass.
    any_valid = jnp.any(cand_valid, axis=-1)
    mcts_move = jnp.where(any_valid & ~board_over, mcts_move, PASS_MOVE)

    # --- root stitching (gumbel.cc:510-557) ---
    sel_n = jnp.take_along_axis(nvis0, mcts_move[:, None], axis=1)[:, 0]
    sel_q = jnp.take_along_axis(q0, mcts_move[:, None], axis=1)[:, 0]
    sel_child = tree.children[b, 0, mcts_move]
    sel_child_s = jnp.clip(sel_child, 0, max_nodes - 1)
    sel_qz = jnp.where(
        sel_child >= 0,
        -jnp.where(tree.n[b, sel_child_s] > 0,
                   tree.w_outcome[b, sel_child_s]
                   / jnp.maximum(tree.n[b, sel_child_s], 1), -1.0),
        -1.0)
    # Reference ratios (gumbel.cc:519-524): the pre-search root value is
    # weighted by the root's accumulated visit count root->n — 1 for fresh
    # roots, the carried count for reused trees (tree reuse default ON) —
    # so carried-over search statistics keep their weight in the recorded
    # root_q_outcome (basis of the q6/q16/q50 TD targets).
    n_root = jnp.maximum(tree.n[:, 0], 1).astype(jnp.float32)
    v_pre = tree.w[:, 0] / n_root
    vz_pre = tree.w_outcome[:, 0] / n_root
    total = n_root + sel_n.astype(jnp.float32)
    root_value = (n_root * v_pre + sel_n * sel_q) / total
    root_outcome = (n_root * vz_pre + sel_n * sel_qz) / total

    # Root value-histogram stitching: fold in the selected child's buckets
    # mirrored (sign flip), gumbel.cc:543-551.
    child_hist = tree.v_categorical[b, sel_child_s, :]  # [B, 51]
    root_value_dist = tree.v_categorical[:, 0, :] + jnp.where(
        (sel_child >= 0)[:, None], child_hist[:, ::-1], 0)

    eps = 1e-10
    kld = jnp.sum(
        jnp.where(pi_improved > 0,
                  pi_improved * (jnp.log(pi_improved + eps)
                                 - jnp.log(probs0 + eps)), 0.0), axis=-1)

    result = GumbelResult(
        mcts_move=mcts_move,
        raw_nn_move=raw_nn_move,
        pi_improved=pi_improved,
        root_value=root_value,
        root_outcome=root_outcome,
        root_score_est=root_score_est,
        q_selected=sel_q,
        qz_selected=sel_qz,
        kld=kld,
        visits=visits_spent,
        root_child_visits=nvis0,
        root_priors=probs0,
        root_value_dist=root_value_dist,
        root_child_q=q0,
    )
    if use_bias:
        # End-of-search bias accumulation (UpdateAndFetch telescoped,
        # bias_cache.h:155-185): obs_err = init_util + sum(edge_w)/(n-1)
        # (edge sums are child-perspective), weight = (n-1)^alpha; per-node
        # deltas vs the last contributed terms keep tree reuse exact.
        from p3achygo_tpu.mcts.bias import bias_accumulate

        nm1 = (tree.n - 1).astype(jnp.float32)
        upd = (tree.bias_slot >= 0) & (tree.n >= 2) & tree.evaluated
        obs_err = tree.init_util \
            + jnp.sum(tree.edge_w, axis=-1) / jnp.maximum(nm1, 1.0)
        w_term = jnp.maximum(nm1, 0.0) ** params.bias_alpha
        obs_term = obs_err * w_term
        d_err = jnp.where(upd, obs_term - tree.bias_obs_last, 0.0)
        d_w = jnp.where(upd, w_term - tree.bias_w_last, 0.0)
        bias_table = bias_accumulate(bias_table, tree.bias_slot, upd,
                                     tree.bias_k0, tree.bias_k1, d_err, d_w)
        tree = tree._replace(
            bias_obs_last=jnp.where(upd, obs_term, tree.bias_obs_last),
            bias_w_last=jnp.where(upd, w_term, tree.bias_w_last))
        if init_tree is not None:
            return result, tree, bias_table
        return result, bias_table
    if init_tree is not None:
        return result, tree
    return result
