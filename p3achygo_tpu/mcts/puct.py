"""Batched PUCT search (mirrors GumbelEvaluator::SearchRootPuct,
gumbel.cc:563-666, and PuctScorer, search_policy.h:133-330).

PUCT action selection at every node of the descent (the reference passes
PuctSearchPolicy for the whole path), with:
- c_puct log visit scaling: c + 0.45 * log((n + 500) / 500)
  (search_policy.h:151-157)
- FPU reduction by explored prior mass: v_fpu = v - fpu * sqrt(p_explored)
  (search_policy.h:214-224, kDefaultFPU = 0.2)
- optional KataGo-style per-child variance scaling of c_puct
  (search_policy.h:256-269)
- root move selection by visit count / best LCB / tempered sample
  (gumbel.cc:628-645); LCB = Q - z * sqrt(QVar / n) (tree.cc:40-67; normal
  z in place of the reference's cached t quantiles).

The in-tree parallel search machinery of the reference (virtual loss,
collision policies, round barriers — cc/mcts/search.cc) has no
equivalent here by design: batching is the board axis, so sims on one board are
sequential and exact, and the whole batch IS the parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import NUM_MOVES, PASS_MOVE
from p3achygo_tpu.game.board import GoState, is_game_over, legal_mask, step
from p3achygo_tpu.mcts.gumbel import (
    _BIG_NEG,
    EvalFn,
    GumbelResult,
    SearchParams,
    _cheap_scores,
    _init_nodes,
    _leaf_score_utility,
    _score_utility,
)
from p3achygo_tpu.mcts.tree import (
    MIN_Q,
    NUM_V_BUCKETS,
    V_BUCKET_RANGE,
    Tree,
    child_visits,
    make_tree,
    q_of_children,
    saturating_edge_add,
    welford_m3_delta,
)
from p3achygo_tpu.constants import BLACK


@dataclasses.dataclass(frozen=True)
class PuctParams:
    """Mirrors mcts::PuctParams (search_policy.h:24-50)."""

    n: int = 64
    c_puct: float = 1.0
    c_puct_visit_scaling: float = 0.45
    fpu: float = 0.2  # kDefaultFPU
    root_fpu: float = 0.2
    enable_var_scaling: bool = False
    var_scale_prior_visits: int = 4
    root_selection: str = "visit_count"  # visit_count | lcb | sample
    tau: float = 0.0
    lcb_z: float = 1.96
    max_depth: int = 32
    score_weight: float = 0.5
    # "direct" | "integral" (ScoreUtilityMode, leaf_evaluator.h:12-16).
    score_utility_mode: str = "direct"
    terminal_mode: str = "cheap"
    # Experimental variants (search_policy.h:24-50):
    # PUCT-V (search_policy.h:292-312): exploration scaled by the child's
    # value stddev plus a log-visit term weighted by c_puct_v_2.
    use_puct_v: bool = False
    c_puct_v_2: float = 3.0
    # M3/skewness bonus (search_policy.h:277-290): children with a larger
    # positive value tail than the visit-weighted average get a bonus that
    # decays with visits (dampened by m3_prior_visits).
    enable_m3_bonus: bool = False
    m3_prior_visits: int = 20
    # Optimistic-policy interpolation (search_policy.h:171-185). The
    # reference blends move_probs with opt_probs per node; the tree stores
    # one prior set, so the blend happens at NN-eval time — build the
    # eval_fn with make_eval_fn(p_opt_weight=...) to honor this knob (the
    # EvalRunner/player_config wiring does). Kept here for config parity.
    p_opt_weight: float = 0.0


def _puct_action(tree: Tree, node: jnp.ndarray, legal: jnp.ndarray,
                 p: PuctParams, is_root: jnp.ndarray,
                 bidx: jnp.ndarray) -> jnp.ndarray:
    """Vectorized PuctScorer::ComputeScores + TopMove."""
    b = bidx
    probs = jnp.exp(tree.log_priors[b, node].astype(jnp.float32))  # [W, 362]
    q = q_of_children(tree, node, b)
    nvis = child_visits(tree, node, b)
    visited = nvis > 0
    n = tree.n[b, node].astype(jnp.float32)
    v = jnp.where(tree.n[b, node] > 0,
                  tree.w[b, node] / jnp.maximum(tree.n[b, node], 1),
                  tree.init_util[b, node])

    p_explored = jnp.sum(jnp.where(visited, probs, 0.0), axis=-1)
    fpu = jnp.where(is_root, p.root_fpu, p.fpu)
    v_fpu = v - fpu * jnp.sqrt(p_explored)

    scale_cpuct = lambda c: c + p.c_puct_visit_scaling * jnp.log(
        (n + 500.0) / 500.0)  # ScaleCPuct (search_policy.h:150-157)
    c_puct = scale_cpuct(p.c_puct)
    canonical_n = 1.0 + jnp.sum(nvis, axis=-1).astype(jnp.float32)

    need_kids = p.enable_var_scaling or p.use_puct_v or p.enable_m3_bonus
    if need_kids:
        # Per-child node stats (variance / third moment). PUCT runs only
        # in eval/GTP/experiments contexts (never the selfplay hot path),
        # so a per-row child gather is acceptable here.
        kids = tree.children[b, node]
        safe = jnp.clip(kids, 0, tree.n.shape[1] - 1)
        kid_n = tree.n[b[:, None], safe].astype(jnp.float32)
        kid_var = jnp.where(
            kid_n > 0, tree.v_var_sum[b[:, None], safe] / jnp.maximum(kid_n, 1),
            0.0)
        kid_std = jnp.sqrt(jnp.maximum(kid_var, 0.0))

    if p.enable_var_scaling:
        # per-child variance scale (search_policy.h:256-269)
        std_mean = jnp.sum(jnp.where(nvis >= 3, kid_std * nvis, 0.0), axis=-1) \
            / jnp.maximum(n, 1.0)
        pw = float(p.var_scale_prior_visits)
        scale = jnp.where(
            (nvis >= 3) & (std_mean[:, None] > 0),
            (pw + nvis * (kid_std / jnp.maximum(std_mean[:, None], 1e-10)))
            / (pw + nvis),
            1.0)
    else:
        scale = 1.0

    if p.use_puct_v:
        # PUCT-V (search_policy.h:292-312): children with uncertain values
        # get extra exploration; var falls back to the parent's (or 1).
        parent_var = jnp.where(n > 0, tree.v_var_sum[b, node]
                               / jnp.maximum(n, 1.0), 0.0)
        fallback = jnp.where(n < 3, 1.0, parent_var)[:, None]
        var_a = jnp.where(nvis >= 3, jnp.maximum(kid_var, 0.0), fallback)
        std_a = jnp.sqrt(jnp.maximum(var_a, 0.0))
        c_puct_v2 = scale_cpuct(p.c_puct_v_2)
        var_scale_term = probs * std_a * (
            jnp.sqrt(canonical_n)[:, None] / (1.0 + nvis))
        n_scale_term = probs * (
            jnp.log(canonical_n)[:, None] / (1.0 + nvis))
        explore = (c_puct[:, None] * var_scale_term
                   + c_puct_v2[:, None] * n_scale_term)
    else:
        explore = (c_puct[:, None] * scale * probs
                   * (jnp.sqrt(canonical_n)[:, None] / (1.0 + nvis)))

    if p.enable_m3_bonus:
        # M3 bonus (search_policy.h:277-290): q_m3 of a child is -v_m3
        # (sign flip into the parent's perspective); its signed cube root
        # is compared with the visit-weighted mean over >=3-visit
        # children.
        kid_m3 = jnp.where(
            kid_n > 0, tree.v_m3_sum[b[:, None], safe] / jnp.maximum(kid_n, 1),
            0.0)
        q_m3 = -kid_m3
        m3_std = jnp.sign(q_m3) * jnp.abs(q_m3) ** (1.0 / 3.0)
        m3_std_mean = jnp.sum(jnp.where(nvis >= 3, m3_std * nvis, 0.0),
                              axis=-1) / jnp.maximum(n, 1.0)
        pm = float(p.m3_prior_visits)
        m3_bonus = jnp.where(
            nvis >= 3,
            (pm + (m3_std - m3_std_mean[:, None])) / (pm + nvis),
            0.0)
    else:
        m3_bonus = 0.0

    canonical_q = jnp.where(visited, q, v_fpu[:, None])
    scores = explore + canonical_q + m3_bonus
    return jnp.argmax(jnp.where(legal, scores, _BIG_NEG), axis=-1).astype(jnp.int32)


def search_root_puct(key: jax.Array, states: GoState, eval_fn: EvalFn,
                     p: PuctParams, return_tree: bool = False):
    """PUCT root search on a batch of boards -> GumbelResult.

    `return_tree=True` additionally stores each new node's board state in
    the tree (Tree s_* fields, normally skipped here because the PUCT
    descent replays moves on scratch boards) and returns
    ``(result, tree)`` so the accumulated tree can seed a Gumbel search
    (tree.compact_root -> gumbel.search_root(init_tree=...)), mirroring
    the PUCT-seeded trees of the reference's visit study
    (experiments/gumbel_visits_study.cc RunSeededGumbel)."""
    from p3achygo_tpu.game.scoring import score as score_board

    B = states.stones.shape[0]
    b = jnp.arange(B)
    max_nodes = p.n + 2
    tree = make_tree(B, max_nodes)
    spare = max_nodes - 1

    root_ev = eval_fn(states)
    root_color = states.to_move
    tree = _init_nodes(tree, jnp.zeros((B,), jnp.int32), root_ev, root_color,
                       root_ev.outcome_value, jnp.ones((B,), jnp.bool_))
    tree = tree._replace(
        n=tree.n.at[:, 0].set(1),
        w=tree.w.at[:, 0].set(root_ev.outcome_value),
        w_outcome=tree.w_outcome.at[:, 0].set(root_ev.outcome_value),
    )
    root_score_est = root_ev.score_est
    legal0 = jax.vmap(legal_mask)(states)
    if return_tree:
        tree = tree._replace(
            s_stones=tree.s_stones.at[:, 0].set(states.stones),
            s_chain=tree.s_chain.at[:, 0].set(
                states.chain_id.astype(jnp.int16)),
            s_last5=tree.s_last5.at[:, 0].set(
                states.last_moves.astype(jnp.int16)),
            s_ko=tree.s_ko.at[:, 0].set(states.ko_point.astype(jnp.int16)),
            s_cpass=tree.s_cpass.at[:, 0].set(
                states.consecutive_passes.astype(jnp.int8)),
            s_hash=tree.s_hash.at[:, 0].set(states.hash),
            s_legal=tree.s_legal.at[:, 0].set(legal0),
        )
    board_over = jax.vmap(is_game_over)(states)
    raw_nn_move = jnp.argmax(root_ev.log_priors, axis=-1).astype(jnp.int32)

    from p3achygo_tpu.game.board import strip_history

    scratch_base = jax.vmap(strip_history)(states)

    def simulate(carry, _):
        tree, key = carry
        valid0 = ~board_over
        D = p.max_depth
        path_nodes0 = jnp.full((B, D), -1, jnp.int32)
        NEW_MARK = jnp.int32(-2)

        # Tree is read-only during the descent (one allocation per sim,
        # applied after the loop) — see gumbel.py for rationale.
        def body(carry):
            (scratch, cur, depth, done, path_nodes, path_actions, leaf_new,
             leaf_terminal, alloc_parent, alloc_action) = carry
            active = ~done
            node = cur
            legal = jax.vmap(legal_mask)(scratch)
            a = _puct_action(tree, node, legal, p, depth == 0, b)

            new_scratch, _ = jax.vmap(step)(scratch, a)
            scratch = jax.tree_util.tree_map(
                lambda new, old: jnp.where(
                    jnp.reshape(active, (B,) + (1,) * (new.ndim - 1)), new, old),
                new_scratch, scratch)

            child = tree.children[b, node, a]
            need_alloc = (child < 0) & active
            child_idx = jnp.where(need_alloc, NEW_MARK, child).astype(jnp.int32)
            alloc_parent = jnp.where(need_alloc, node, alloc_parent)
            alloc_action = jnp.where(need_alloc, a, alloc_action)
            terminal_board = jax.vmap(is_game_over)(scratch) & active
            known_terminal = (child >= 0) & tree.is_terminal[
                b, jnp.clip(child_idx, 0, max_nodes - 1)]
            stop = (need_alloc | terminal_board | known_terminal) & active
            path_nodes = path_nodes.at[b, depth].set(
                jnp.where(active, child_idx, path_nodes[b, depth]))
            path_actions = path_actions.at[b, depth].set(
                jnp.where(active, a, path_actions[b, depth]))
            leaf_new = jnp.where(stop & need_alloc & ~terminal_board, True,
                                 leaf_new)
            leaf_terminal = jnp.where(stop & terminal_board, True, leaf_terminal)
            cur = jnp.where(active, child_idx, cur)
            depth = depth + active.astype(jnp.int32)
            done = done | stop | (depth >= D)
            return (scratch, cur, depth, done, path_nodes, path_actions,
                    leaf_new, leaf_terminal, alloc_parent, alloc_action)

        init = (scratch_base, jnp.zeros((B,), jnp.int32),
                jnp.zeros((B,), jnp.int32), ~valid0, path_nodes0,
                jnp.zeros((B, D), jnp.int32),
                jnp.zeros((B,), jnp.bool_), jnp.zeros((B,), jnp.bool_),
                jnp.full((B,), spare, jnp.int32), jnp.zeros((B,), jnp.int32))
        (leaf_states, cur_final, depth, _, path_nodes, path_actions, leaf_new,
         leaf_terminal, alloc_parent, alloc_action) = jax.lax.while_loop(
            lambda c: ~jnp.all(c[3]), body, init)

        allocated = (cur_final == NEW_MARK) & valid0
        new_idx = tree.next_free.astype(jnp.int32)
        leaf_node = jnp.where(allocated, new_idx,
                              jnp.clip(cur_final, 0, max_nodes - 1))
        path_nodes = jnp.where(path_nodes == NEW_MARK, new_idx[:, None],
                               path_nodes)
        wp = jnp.where(allocated, alloc_parent, spare)
        wa = jnp.where(allocated, alloc_action, 0)
        ln_routed = jnp.where(allocated, leaf_node, spare)
        tree = tree._replace(
            children=tree.children.at[b, wp, wa].set(
                jnp.where(allocated, leaf_node,
                          tree.children[b, wp, wa].astype(jnp.int32))
                .astype(tree.children.dtype)),
            parent=tree.parent.at[b, ln_routed].set(
                jnp.where(allocated, alloc_parent, tree.parent[b, ln_routed])),
            parent_action=tree.parent_action.at[b, ln_routed].set(
                jnp.where(allocated, alloc_action,
                          tree.parent_action[b, ln_routed])),
            next_free=tree.next_free + allocated.astype(jnp.int32),
        )
        if return_tree:
            # Store the new node's board state so the returned tree can seed
            # a Gumbel search (gumbel descents read stored node states
            # instead of replaying moves — see Tree s_* fields).
            leaf_legal = jax.vmap(legal_mask)(leaf_states)
            al = allocated
            tree = tree._replace(
                s_stones=tree.s_stones.at[b, ln_routed].set(
                    jnp.where(al[:, None], leaf_states.stones,
                              tree.s_stones[b, ln_routed])),
                s_chain=tree.s_chain.at[b, ln_routed].set(
                    jnp.where(al[:, None],
                              leaf_states.chain_id.astype(jnp.int16),
                              tree.s_chain[b, ln_routed])),
                s_last5=tree.s_last5.at[b, ln_routed].set(
                    jnp.where(al[:, None],
                              leaf_states.last_moves.astype(jnp.int16),
                              tree.s_last5[b, ln_routed])),
                s_ko=tree.s_ko.at[b, ln_routed].set(
                    jnp.where(al, leaf_states.ko_point.astype(jnp.int16),
                              tree.s_ko[b, ln_routed])),
                s_cpass=tree.s_cpass.at[b, ln_routed].set(
                    jnp.where(al,
                              leaf_states.consecutive_passes.astype(jnp.int8),
                              tree.s_cpass[b, ln_routed])),
                s_hash=tree.s_hash.at[b, ln_routed].set(
                    jnp.where(al[:, None], leaf_states.hash,
                              tree.s_hash[b, ln_routed])),
                s_legal=tree.s_legal.at[b, ln_routed].set(
                    jnp.where(al[:, None], leaf_legal,
                              tree.s_legal[b, ln_routed])),
            )

        leaf_color = leaf_states.to_move
        root_sign = jnp.where(leaf_color == root_color, 1.0, -1.0)
        ev = eval_fn(leaf_states)
        util = ev.outcome_value + _leaf_score_utility(
            p, ev.score_est, ev.score_var, root_sign * root_score_est)
        tree = _init_nodes(tree, leaf_node, ev, leaf_color, util,
                           leaf_new & valid0)

        def with_terminal(tree):
            if p.terminal_mode == "exact":
                bs, ws, _ = jax.vmap(score_board)(leaf_states)
            else:
                bs, ws = _cheap_scores(leaf_states)
            player = jnp.where(leaf_color == BLACK, bs, ws)
            oppv = jnp.where(leaf_color == BLACK, ws, bs)
            final_score = player - oppv
            emp_out = jnp.where(player > oppv, 1.0, -1.0)
            emp_q = emp_out + _leaf_score_utility(
                p, final_score, jnp.zeros_like(final_score),
                root_sign * root_score_est)
            t_active = leaf_terminal & valid0 & ~tree.is_terminal[b, leaf_node]
            ln = jnp.where(t_active, leaf_node, spare)
            sel = lambda new, old: jnp.where(t_active, new, old)
            return tree._replace(
                init_util=tree.init_util.at[b, ln].set(
                    sel(emp_q, tree.init_util[b, ln])),
                init_outcome=tree.init_outcome.at[b, ln].set(
                    sel(emp_out, tree.init_outcome[b, ln])),
                init_score=tree.init_score.at[b, ln].set(
                    sel(final_score, tree.init_score[b, ln])),
                color=tree.color.at[b, ln].set(
                    jnp.where(t_active, leaf_color,
                              tree.color[b, ln]).astype(jnp.int8)),
                is_terminal=tree.is_terminal.at[b, ln].set(
                    tree.is_terminal[b, ln] | t_active),
                evaluated=tree.evaluated.at[b, ln].set(
                    tree.evaluated[b, ln] | t_active),
            )

        if p.terminal_mode == "exact":
            tree = jax.lax.cond(jnp.any(leaf_terminal & valid0), with_terminal,
                                lambda t: t, tree)
        else:
            tree = with_terminal(tree)

        # backprop incl. the root (SearchRootPuct paths start at the root,
        # first_is_root=true, gumbel.cc:604-609) via one-hot contraction.
        leaf_q = tree.init_util[b, leaf_node]
        leaf_qz = tree.init_outcome[b, leaf_node]
        leaf_score = tree.init_score[b, leaf_node]
        leaf_c = tree.color[b, leaf_node]
        root_inc = valid0  # root itself gets a visit per sim

        nodes = path_nodes  # [B, D]
        on_path = (nodes >= 0) & valid0[:, None]
        node_s = jnp.clip(nodes, 0, max_nodes - 1)
        sign = jnp.where(tree.color[b[:, None], node_s] == leaf_c[:, None],
                         1.0, -1.0)
        is_leaf_slot = nodes == leaf_node[:, None]
        q = sign * leaf_q[:, None]
        qz = sign * leaf_qz[:, None]
        sc = sign * leaf_score[:, None]
        add_w = jnp.where(is_leaf_slot, tree.init_util[b[:, None], node_s], q)
        add_wz = jnp.where(is_leaf_slot, tree.init_outcome[b[:, None], node_s],
                           qz)
        add_sc = jnp.where(is_leaf_slot, tree.init_score[b[:, None], node_s],
                           sc)
        n_old = tree.n[b[:, None], node_s].astype(jnp.float32)
        v_old = jnp.where(n_old > 0,
                          tree.w[b[:, None], node_s] / jnp.maximum(n_old, 1),
                          tree.init_util[b[:, None], node_s])
        w_new = tree.w[b[:, None], node_s] + jnp.where(on_path, add_w, 0.0)
        v_new = w_new / jnp.maximum(n_old + on_path, 1)
        dvar = (q - v_old) * (q - v_new)
        vz_old = jnp.where(
            n_old > 0,
            tree.w_outcome[b[:, None], node_s] / jnp.maximum(n_old, 1),
            tree.init_outcome[b[:, None], node_s])
        wz_new = (tree.w_outcome[b[:, None], node_s]
                  + jnp.where(on_path, add_wz, 0.0))
        vz_new = wz_new / jnp.maximum(n_old + on_path, 1)
        dvar_z = (qz - vz_old) * (qz - vz_new)
        # Third-moment increment (v_m3, tree.h:46; see welford_m3_delta).
        dm3 = welford_m3_delta(q, v_old, n_old + on_path,
                               tree.v_var_sum[b[:, None], node_s], dvar)
        bucket = jnp.clip(((qz + 1.0) / V_BUCKET_RANGE).astype(jnp.int32), 0,
                          NUM_V_BUCKETS - 1)
        nonleaf = on_path & ~is_leaf_slot
        D_ = nodes.shape[1]
        oh = jax.nn.one_hot(node_s, max_nodes, dtype=jnp.float32)
        onp = on_path.astype(jnp.float32)
        nlf = nonleaf.astype(jnp.float32)
        acc = lambda vals, m: jnp.einsum("bi,bin->bn", vals * m, oh,
                                         preferred_element_type=jnp.float32)
        oh_bucket = jax.nn.one_hot(bucket, NUM_V_BUCKETS, dtype=jnp.float32)
        cat_add = jnp.einsum("bin,bik->bnk", oh * nlf[:, :, None], oh_bucket,
                             preferred_element_type=jnp.float32)
        # Edge updates: (parent, action) accumulates the child's increments
        # (see gumbel.py); the first path entry's parent is the root.
        from p3achygo_tpu.constants import NUM_MOVES as _NM

        parents = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), node_s[:, :-1]], axis=1)
        oh_parent = jax.nn.one_hot(parents, max_nodes, dtype=jnp.float32)
        oh_act = jax.nn.one_hot(path_actions, _NM, dtype=jnp.float32)
        edge = lambda vals, m: jnp.einsum(
            "bin,bia->bna", oh_parent * (vals * m)[:, :, None], oh_act,
            preferred_element_type=jnp.float32)

        # root backup (leaf value signed into root's perspective)
        root_sign_v = jnp.where(tree.color[:, 0] == leaf_c, 1.0, -1.0)
        tree = tree._replace(
            n=(tree.n + acc(onp, onp).astype(jnp.int32)).at[:, 0].add(
                root_inc.astype(jnp.int32)),
            w=(tree.w + acc(add_w, onp)).at[:, 0].add(
                jnp.where(root_inc, root_sign_v * leaf_q, 0.0)),
            w_outcome=(tree.w_outcome + acc(add_wz, onp)).at[:, 0].add(
                jnp.where(root_inc, root_sign_v * leaf_qz, 0.0)),
            score_sum=tree.score_sum + acc(add_sc, onp),
            v_var_sum=tree.v_var_sum + acc(dvar, nlf),
            vz_var_sum=tree.vz_var_sum + acc(dvar_z, nlf),
            v_m3_sum=tree.v_m3_sum + acc(dm3, nlf),
            v_categorical=tree.v_categorical + cat_add.astype(jnp.int32),
            edge_n=saturating_edge_add(tree.edge_n, edge(onp, onp)),
            edge_w=tree.edge_w + edge(add_w, onp),
            edge_wz=tree.edge_wz + edge(add_wz, onp),
        )
        return (tree, key), valid0.astype(jnp.int32)

    (tree, key), valid_counts = jax.lax.scan(
        simulate, (tree, key), None, length=p.n)
    visits_spent = jnp.sum(valid_counts, axis=0)

    # Improved policy = visit-count distribution (gumbel.cc:617-627).
    nvis0 = child_visits(tree, jnp.zeros((B,), jnp.int32))
    total = jnp.maximum(jnp.sum(nvis0, axis=-1), 1).astype(jnp.float32)
    pi_improved = nvis0.astype(jnp.float32) / total[:, None]

    q0 = q_of_children(tree, jnp.zeros((B,), jnp.int32))

    if p.root_selection == "lcb":
        kids = tree.children[b[:, None],
                             jnp.zeros((B, 1), jnp.int32), :][:, 0, :]
        safe = jnp.clip(kids, 0, max_nodes - 1)
        kid_n = tree.n[b[:, None], safe].astype(jnp.float32)
        kid_var = jnp.where(
            kid_n > 0, tree.v_var_sum[b[:, None], safe] / jnp.maximum(kid_n, 1),
            0.0)
        lcb = jnp.where(
            (kids >= 0) & (kid_n >= 2),
            q0 - p.lcb_z * jnp.sqrt(jnp.maximum(kid_var, 0.0) / jnp.maximum(kid_n, 1)),
            -1e6 + kid_n)
        mcts_move = jnp.argmax(jnp.where(legal0, lcb, _BIG_NEG),
                               axis=-1).astype(jnp.int32)
    elif p.root_selection == "sample" and p.tau > 0:
        key, ks = jax.random.split(key)
        logits = jnp.where(pi_improved > 0,
                           jnp.log(jnp.maximum(pi_improved, 1e-30)) / p.tau,
                           _BIG_NEG)
        mcts_move = jax.random.categorical(ks, logits, axis=-1).astype(jnp.int32)
    else:
        mcts_move = jnp.argmax(
            jnp.where(legal0, nvis0.astype(jnp.float32), _BIG_NEG),
            axis=-1).astype(jnp.int32)

    mcts_move = jnp.where(board_over, PASS_MOVE, mcts_move)

    sel_n = jnp.take_along_axis(nvis0, mcts_move[:, None], axis=1)[:, 0]
    sel_q = jnp.take_along_axis(q0, mcts_move[:, None], axis=1)[:, 0]
    root_v = jnp.where(tree.n[:, 0] > 0,
                       tree.w[:, 0] / jnp.maximum(tree.n[:, 0], 1),
                       root_ev.outcome_value)
    root_vz = jnp.where(tree.n[:, 0] > 0,
                        tree.w_outcome[:, 0] / jnp.maximum(tree.n[:, 0], 1),
                        root_ev.outcome_value)

    eps = 1e-10
    probs0 = jax.nn.softmax(jnp.where(legal0, root_ev.log_priors, _BIG_NEG),
                            axis=-1)
    kld = jnp.sum(
        jnp.where(pi_improved > 0,
                  pi_improved * (jnp.log(pi_improved + eps)
                                 - jnp.log(probs0 + eps)), 0.0), axis=-1)

    result = GumbelResult(
        mcts_move=mcts_move,
        raw_nn_move=raw_nn_move,
        pi_improved=pi_improved,
        root_value=root_v,
        root_outcome=root_vz,
        root_score_est=root_score_est,
        q_selected=sel_q,
        qz_selected=jnp.where(sel_n > 0, sel_q, -1.0),
        kld=kld,
        visits=visits_spent,
        root_child_visits=nvis0,
        root_priors=probs0,
        root_value_dist=tree.v_categorical[:, 0, :],
        root_child_q=q0,
    )
    if return_tree:
        return result, tree
    return result
