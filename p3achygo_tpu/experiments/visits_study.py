"""Gumbel visit-count study (cc/experiments/gumbel_visits_study.cc).

Measures, per position, the KLD between a "ground-truth" improved policy
(Gumbel N=gt_n K=16, or PUCT N=gt_n empirical visit distribution with
--use_gumbel=false) and the improved policy produced by an N-visit search
for each N in a sweep. Each N-visit Gumbel search is first seeded with
`seed_visits` PUCT visits (simulating self-play tree reuse) via
search_root_puct(return_tree=True) -> init_tree, mirroring RunSeededGumbel
(gumbel_visits_study.cc:219-241).

Redesign: the reference's per-example loop collapses into ONE lockstep
batch per (search kind, N): all positions search simultaneously. The fixed
per-position seed trick (gumbel_visits_study.cc:427-429: same Gumbel noise
=> same top-K actions across GT and every N) is preserved by passing the
SAME PRNG key to the GT and every seeded N-search — gumbel.search_root
draws its root noise from the key before any n-dependent branching, so the
candidate sets match exactly.

Deviations (documented): the reference study's PUCT config sets
p_opt_weight=1.0 (optimistic-policy interpolation, search_policy.h:171-185)
which this PUCT implementation does not expose; its per-search BiasCache
(alpha=0.8, lambda=0.3 for Gumbel) is honored for Gumbel searches via
SearchParams.bias_lambda + a fresh BiasTable per search, but not for the
PUCT seeding pass (mcts/puct.py takes no bias table).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import BLACK, NUM_MOVES, PASS_MOVE
from p3achygo_tpu.game.board import GoState, from_stones
from p3achygo_tpu.mcts.bias import make_bias_table
from p3achygo_tpu.mcts.gumbel import (EvalFn, GumbelResult, SearchParams,
                                      search_root)
from p3achygo_tpu.mcts.puct import PuctParams, search_root_puct

# gumbel_visits_study.cc:87-92.
GROUND_TRUTH_VISITS = 10000
STUDY_K = 16
DEFAULT_N_VALUES = (64, 100, 150, 200, 300, 400, 800)


def states_from_examples(examples: Sequence[dict]) -> GoState:
    """Reconstruct a batch of GoStates from decoded training examples.

    Mirrors BuildBoard (gumbel_visits_study.cc:158-174): the position is
    rebuilt from the raw stones array (chains/hash recomputed by
    from_stones), last_moves/color/komi restored from the example.
    """
    stones = np.stack([
        np.frombuffer(ex["board"], np.int8) for ex in examples])
    last_moves = np.stack([
        np.frombuffer(ex["last_moves"], np.int16).astype(np.int32)
        for ex in examples])
    colors = np.array([
        np.frombuffer(ex["color"], np.int8)[0] for ex in examples], np.int8)
    komis = np.array([float(ex["komi"][0]) for ex in examples], np.float32)
    states = jax.vmap(from_stones)(
        jnp.asarray(stones), jnp.asarray(komis), jnp.asarray(colors))
    return states._replace(last_moves=jnp.asarray(last_moves))


def compute_kld(target: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """ComputeKLD (gumbel.cc:183-193): sum target*log(target/(prior+eps))
    over target>0 entries. Batched: [B, 362] x [B, 362] -> [B]."""
    eps = 1e-10
    term = np.where(target > 0.0,
                    target * np.log(np.maximum(target, eps)
                                    / (prior + eps)), 0.0)
    # KLD >= 0 by definition; float error (bf16-stored priors) can leave
    # a ~1e-8 negative residue when target == prior.
    return np.maximum(term.sum(axis=-1), 0.0)


def _stats(vals: np.ndarray) -> Dict[str, float]:
    """mean/p75/p95/max (gumbel_visits_study.cc:318-339)."""
    v = np.sort(np.asarray(vals, np.float64))
    if v.size == 0:
        return {"mean": 0.0, "p75": 0.0, "p95": 0.0, "max": 0.0}

    def pct(p):
        idx = p * (v.size - 1)
        lo = int(idx)
        hi = min(lo + 1, v.size - 1)
        return float(v[lo] + (idx - lo) * (v[hi] - v[lo]))

    return {"mean": float(v.mean()), "p75": pct(0.75), "p95": pct(0.95),
            "max": float(v[-1])}


def _empirical_dist(child_visits: np.ndarray) -> np.ndarray:
    """Normalized root visit distribution (EmpiricalVisitDist,
    gumbel_visits_study.cc:244-256)."""
    total = child_visits.sum(axis=-1, keepdims=True)
    return np.where(total > 0, child_visits / np.maximum(total, 1), 0.0)


# PUCT config for --use_gumbel=false mode (kStudyPuctParams,
# gumbel_visits_study.cc:258-265; p_opt_weight not exposed — see module
# docstring).
def _study_puct(n: int, max_depth: int) -> PuctParams:
    return PuctParams(n=n, root_fpu=0.1, enable_var_scaling=True,
                      var_scale_prior_visits=10, root_selection="lcb",
                      max_depth=max_depth)


def run_visits_study(eval_fn: EvalFn, states: GoState,
                     n_values: Sequence[int] = DEFAULT_N_VALUES,
                     gt_n: int = GROUND_TRUTH_VISITS,
                     k: int = STUDY_K,
                     seed_visits: int = 30,
                     use_gumbel: bool = True,
                     bias_lambda: float = 0.3,
                     bias_alpha: float = 0.8,
                     max_depth: int = 32,
                     seed: int = 0) -> Dict:
    """Run the study over one batch of positions; returns the report dict.

    Report: {"prior": stats, "per_n": [{"n", "kld_gt": stats,
    "kld_prior": stats, "nats_per_visit"}, ...], "gt_best", "n_best"}.
    """
    B = states.stones.shape[0]
    key = jax.random.PRNGKey(seed)
    key_pos, key_seed = jax.random.split(key)

    def bias_table():
        return make_bias_table(B) if bias_lambda > 0 else None

    def unpack(out):
        # search_root returns (result[, tree][, bias_table]) depending on
        # init_tree/bias_table; the result always leads. GumbelResult is
        # itself a (Named)tuple, so check for it FIRST — `out[0]` on a bare
        # result would silently grab mcts_move.
        if isinstance(out, GumbelResult):
            return out
        return out[0] if isinstance(out, tuple) else out

    if use_gumbel:
        gt_params = SearchParams(n=gt_n, k=k, max_depth=max_depth,
                                 bias_lambda=bias_lambda,
                                 bias_alpha=bias_alpha)
        gt_res = unpack(search_root(key_pos, states, eval_fn, gt_params,
                                    bias_table=bias_table()))
        gt_pi = np.asarray(gt_res.pi_improved)
        prior = np.asarray(gt_res.root_priors)
        gt_best = np.asarray(gt_res.mcts_move)
    else:
        gt_res = search_root_puct(key_pos, states, eval_fn,
                                  _study_puct(gt_n, max_depth))
        gt_pi = _empirical_dist(np.asarray(gt_res.root_child_visits,
                                           np.float64))
        prior = np.asarray(gt_res.root_priors)
        gt_best = np.asarray(gt_res.mcts_move)

    kld_prior = compute_kld(gt_pi, prior)
    prior_stats = _stats(kld_prior)

    per_n: List[Dict] = []
    n_best: Dict[int, np.ndarray] = {}
    for n in n_values:
        if use_gumbel:
            seed_tree = None
            cap = 0
            if seed_visits > 0:
                pp = PuctParams(n=seed_visits, root_selection="lcb",
                                max_depth=max_depth)
                _, seed_tree = search_root_puct(key_seed, states, eval_fn,
                                                pp, return_tree=True)
                cap = seed_tree.n.shape[1]
            np_params = SearchParams(n=n, k=k, max_depth=max_depth,
                                     bias_lambda=bias_lambda,
                                     bias_alpha=bias_alpha)
            # SAME key as GT => same Gumbel noise => same top-K actions
            # (the fixed pos_seed of gumbel_visits_study.cc:477-481).
            res = unpack(search_root(key_pos, states, eval_fn, np_params,
                                     init_tree=seed_tree,
                                     reuse_capacity=cap,
                                     bias_table=bias_table()))
            pi_n = np.asarray(res.pi_improved)
            best = np.asarray(res.mcts_move)
        else:
            res = search_root_puct(key_pos, states, eval_fn,
                                   _study_puct(n, max_depth))
            pi_n = _empirical_dist(np.asarray(res.root_child_visits,
                                              np.float64))
            best = np.asarray(res.mcts_move)
        kld_gt = compute_kld(gt_pi, pi_n)
        kld_pd = compute_kld(pi_n, prior)
        s = _stats(kld_gt)
        per_n.append({
            "n": n,
            "kld_gt": s,
            "kld_prior": _stats(kld_pd),
            "nats_per_visit": (prior_stats["mean"] - s["mean"]) / n,
        })
        n_best[n] = best

    return {
        "examples": B,
        "mode": "gumbel" if use_gumbel else "puct",
        "gt_n": gt_n,
        "k": k,
        "seed_visits": seed_visits,
        "prior": prior_stats,
        "per_n": per_n,
        "gt_best": gt_best,
        "n_best": n_best,
    }


def format_report(report: Dict) -> str:
    """Render the summary table (gumbel_visits_study.cc:534-555)."""
    lines = ["", "Visit Count Study"]
    if report["mode"] == "gumbel":
        lines.append(
            f"Mode:         Gumbel (GT: N={report['gt_n']} "
            f"K={report['k']}, seed: {report['seed_visits']} PUCT visits)")
    else:
        lines.append(
            f"Mode:         PUCT (GT: N={report['gt_n']} fpu=0.1, "
            "empirical visit dist)")
    lines.append(f"Examples:     {report['examples']}")
    p = report["prior"]
    lines.append("")
    lines.append(
        f"KLD(GT, prior) -- mean: {p['mean']:.5f}  p75: {p['p75']:.5f}  "
        f"p95: {p['p95']:.5f}  max: {p['max']:.5f}")
    lines.append("")
    lines.append(f"{'N':<8}  {'KLD(GT||N)':<12}  {'KLD(N||prior)':<13}  "
                 f"{'nats/visit':<12}")
    lines.append(f"{'-'*8}  {'-'*12}  {'-'*13}  {'-'*12}")
    for row in report["per_n"]:
        lines.append(f"{row['n']:<8}  {row['kld_gt']['mean']:<12.5f}  "
                     f"{row['kld_prior']['mean']:<13.5f}  "
                     f"{row['nats_per_visit']:<12.6f}")
    return "\n".join(lines)


def load_chunk_examples(chunk_path: str, num_examples: int) -> List[dict]:
    """Read + decode up to num_examples examples from a tfrecord chunk."""
    from p3achygo_tpu.data.example import decode_example
    from p3achygo_tpu.data.tfrecord import read_records
    out = []
    for rec in read_records(chunk_path):
        try:
            out.append(decode_example(rec))
        except Exception:
            continue  # skip unparseable records (study main loop skips too)
        if len(out) >= num_examples:
            break
    return out
