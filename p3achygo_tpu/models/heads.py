"""Policy and value heads (plain JAX over models/layers.Scope).

Mirrors python/model.py PolicyHead (model.py:725-823) and ValueHead
(model.py:824-990) semantically: same sub-layers, same outputs, same
"-3 pass-logit bias" trick, same score-bin conditioning of the score head.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import NUM_SCORE_LOGITS, NUM_V_BUCKETS
from p3achygo_tpu.models.blocks import global_pool, global_pool_bias, mish
from p3achygo_tpu.models.layers import Scope, conv, dense, lecun_normal, zeros


def policy_head(s: Scope, x, channels: int, dtype):
    """-> (pi, pi_aux, pi_soft, pi_optimistic) logits, each [N, 362]."""
    n = x.shape[0]
    p = conv(s.child("conv_p"), x, channels, 1, dtype)
    g = conv(s.child("conv_g"), x, channels, 1, dtype)
    p, g_pooled = global_pool_bias(s.child("gpool"), p, g, channels, dtype)
    p = mish(p)

    pi_both = conv(s.child("output_moves"), p, 2, 1, dtype)
    # Bias the pass logit down so the model learns when to pass rather
    # than when not to (model.py:800-802).
    pass_logits = dense(s.child("output_pass"), g_pooled, 2, dtype) - 3.0

    pi = jnp.concatenate(
        [pi_both[..., 0].reshape(n, -1), pass_logits[:, 0:1]], axis=1)
    pi_aux = jnp.concatenate(
        [pi_both[..., 1].reshape(n, -1), pass_logits[:, 1:2]], axis=1)

    pi_soft_board = conv(s.child("soft_moves"), p, 1, 1, dtype).reshape(n, -1)
    pass_soft = dense(s.child("soft_pass"), g_pooled, 1, dtype) - 3.0
    pi_soft = jnp.concatenate([pi_soft_board, pass_soft], axis=1)

    pi_opt_board = conv(s.child("optimistic_moves"), p, 1, 1,
                        dtype).reshape(n, -1)
    pass_opt = dense(s.child("optimistic_pass"), g_pooled, 1, dtype) - 3.0
    pi_opt = jnp.concatenate([pi_opt_board, pass_opt], axis=1)
    return pi, pi_aux, pi_soft, pi_opt


def value_head(s: Scope, x, channels: int, c_val: int, dtype, scores=None):
    """-> dict of value-family outputs (see model.py:824-990)."""
    n = x.shape[0]
    if scores is None:
        scores = 0.05 * jnp.arange(
            -NUM_SCORE_LOGITS // 2, NUM_SCORE_LOGITS // 2,
            dtype=jnp.float32) + 0.025

    v = conv(s.child("conv"), x, channels, 1, dtype)
    v_pooled = global_pool(v)  # [N, 2*channels]

    embed = mish(dense(s.child("outcome_q_embed"), v_pooled, c_val, dtype))
    game_outcome = dense(s.child("outcome_q_output"), embed, 14, dtype)
    game_outcome = game_outcome.astype(jnp.float32)

    mcts_dist_logits = dense(s.child("outcome_mcts_dist"), embed,
                             NUM_V_BUCKETS, dtype).astype(jnp.float32)

    ownership = jnp.tanh(
        conv(s.child("conv_ownership"), v, 1, 1, dtype)).reshape(n, -1)

    gamma = mish(dense(s.child("gamma_pre"), v_pooled, c_val, dtype))
    gamma = dense(s.child("gamma_output"), gamma, 1, dtype,
                  kernel_init=zeros).astype(jnp.float32)

    # Score distribution: condition pooled features on each score bin.
    # Algebraically split the reference's Dense over concat([v_pooled,
    # score_bin]) (model.py:938-960) into a shared v-term plus a per-bin
    # scalar term, so no [N, 800, 65] broadcast is materialized.
    scores = scores.astype(dtype)
    u = dense(s.child("score_pre_v"), v_pooled, c_val, dtype)  # [N, c_val]
    w_s = s.param("score_pre_s", lecun_normal, (1, c_val)).astype(dtype)
    h = mish(u[:, None, :] + scores[None, :, None] * w_s[None, :, :])
    score_logits = dense(s.child("score_output"), h, 1, dtype)[..., 0]
    score_logits = (
        jnp.minimum(jax.nn.softplus(gamma), 10.0).astype(jnp.float32)
        * score_logits.astype(jnp.float32))

    return dict(
        outcome_logits=game_outcome[:, 0:2],
        ownership=ownership.astype(jnp.float32),
        score_logits=score_logits,
        gamma=gamma,
        q6=jnp.tanh(game_outcome[:, 2]),
        q16=jnp.tanh(game_outcome[:, 3]),
        q50=jnp.tanh(game_outcome[:, 4]),
        q6_err=4.0 * jax.nn.sigmoid(game_outcome[:, 5]),
        q16_err=4.0 * jax.nn.sigmoid(game_outcome[:, 6]),
        q50_err=4.0 * jax.nn.sigmoid(game_outcome[:, 7]),
        q6_score=game_outcome[:, 8],
        q16_score=game_outcome[:, 9],
        q50_score=game_outcome[:, 10],
        q6_score_err=jnp.abs(game_outcome[:, 11]),
        q16_score_err=jnp.abs(game_outcome[:, 12]),
        q50_score_err=jnp.abs(game_outcome[:, 13]),
        mcts_dist_logits=mcts_dist_logits,
    )
