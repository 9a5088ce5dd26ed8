"""Serve-time folded inference graph (the TRT-engine analogue).

The reference builds a dedicated serving engine from the trained graph
(cc/nn/engine/trt_engine.cc:177-215: TF graph -> ONNX -> TensorRT with
fused BN and pruned training-only nodes, worth ~25% there,
notes/journal.md:139). Here it is a parameter-level rebuild of the forward
pass:

* **BN fold.** At inference BatchNorm is an affine ``a*x + b`` per channel
  (a = scale/sqrt(var+eps), b = bias - mean*a). In a pre-activation
  ConvBlock chain ``... -> conv_i -> BN_{i+1} -> mish -> conv_{i+1} ...``
  the affine folds into the *preceding* conv's kernel/bias
  (``conv(u, W*a) + b``), so the elementwise stream between convolutions
  shrinks to a single ``mish`` — XLA fuses that into the convolution
  fusions instead of emitting standalone BN/mish memory passes.
  Chain-head ConvBlocks read the residual stream (consumed raw by the
  residual add as well), so their BN stays as an explicit precomputed
  affine — still cheaper than a BatchNorm's rsqrt + 4 param streams.

* **Head pruning.** Search consumes pi (+ optionally pi_optimistic),
  outcome, the score distribution, and q6_err (mcts/gumbel.py
  make_eval_fn); ownership, aux/soft policies and the MCTS-dist head are
  training-only targets (model.py:1264-1289 emits all 25 outputs
  unconditionally). The serve graph skips them.

Fold math runs on the *weights* inside the traced function (a few MB), so
weights stay traced arguments — no per-generation recompiles — and XLA
hoists the folded constants per call for free.

Parity: tests/test_serve_fold.py (f32 near-exact + bf16 top-1 vs
`model.apply`, all conv trunk families).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from p3achygo_tpu.constants import NUM_SCORE_LOGITS, NUM_V_BUCKETS
from p3achygo_tpu.models.blocks import mish
from p3achygo_tpu.models.model import ModelOutputs

BN_EPS = 1e-3
_DN = ("NHWC", "HWIO", "NHWC")


def serve_supported(config) -> bool:
    """Conv-family trunks only (classic/btl/nbt + broadcast); the
    transformer trunk serves through `model.apply`."""
    return not getattr(config, "is_transformer", False)


def _affine(bn_p, bn_s) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """BatchNorm(inference) == a*x + b, precomputed in f32."""
    inv = lax.rsqrt(bn_s["var"].astype(jnp.float32) + BN_EPS)
    a = bn_p["scale"].astype(jnp.float32) * inv
    b = bn_p["bias"].astype(jnp.float32) - bn_s["mean"].astype(jnp.float32) * a
    return a, b


def _conv(x, kernel, dtype, bias=None):
    y = lax.conv_general_dilated(x, kernel.astype(dtype), (1, 1), "SAME",
                                 dimension_numbers=_DN)
    if bias is not None:
        y = y + bias.astype(dtype)
    return y


def _dense(x, p, dtype):
    return x @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


class _CB:
    """One ConvBlock's raw pieces (BN params/stats + conv kernel)."""

    __slots__ = ("bn_p", "bn_s", "kernel")

    def __init__(self, p, s):
        self.bn_p = p["BatchNorm_0"]
        self.bn_s = s["BatchNorm_0"]
        self.kernel = p["Conv_0"]["kernel"]


def _chain(x, cbs: Sequence[_CB], dtype):
    """Run a ConvBlock chain with every in-chain BN folded into its
    producer conv. The chain head's BN stays an explicit affine."""
    a0, b0 = _affine(cbs[0].bn_p, cbs[0].bn_s)
    u = mish(x * a0.astype(dtype) + b0.astype(dtype))
    for i, cb in enumerate(cbs):
        w = cb.kernel.astype(jnp.float32)
        bias = None
        if i + 1 < len(cbs):
            a_n, b_n = _affine(cbs[i + 1].bn_p, cbs[i + 1].bn_s)
            w = w * a_n  # scale output channels (last HWIO axis)
            bias = b_n
        u = _conv(u, w, dtype, bias)
        if i + 1 < len(cbs):
            u = mish(u)
    return u


def _btl_block(x, p, s, inner: int, dtype):
    cbs = [_CB(p["reduce"], s["reduce"])]
    cbs += [_CB(p[f"inner_{j}"], s[f"inner_{j}"]) for j in range(inner)]
    cbs += [_CB(p["expand"], s["expand"])]
    return x + _chain(x, cbs, dtype)


def _classic_block(x, p, s, stack: int, dtype):
    cbs = [_CB(p[f"conv_{j}"], s[f"conv_{j}"]) for j in range(stack)]
    return x + _chain(x, cbs, dtype)


def _nbt_block(x, p, s, dtype):
    # reduce -> classic res0 -> classic res1 -> expand; the classic
    # sub-blocks and the expand read residual sums, so chains break there
    # and only intra-chain folds apply (reduce+res0.conv_0 share a chain
    # boundary at res0's residual read — reduce stays a 1-chain).
    h = _chain(x, [_CB(p["reduce"], s["reduce"])], dtype)
    for r in ("nbt_res0", "nbt_res1"):
        cbs = [_CB(p[r][f"conv_{j}"], s[r][f"conv_{j}"]) for j in range(2)]
        h = h + _chain(h, cbs, dtype)
    out = _chain(h, [_CB(p["expand"], s["expand"])], dtype)
    return x + out


def _broadcast_block(x, p, s, dtype):
    u = _chain(x, [_CB(p["conv_first"], s["conv_first"])], dtype)
    n, h, w, c = u.shape
    m = mish(u)
    m = jnp.transpose(m, (0, 3, 1, 2)).reshape(n, c, h * w)
    z = _dense(m, p["mix"]["Dense_0"], dtype)
    z = jnp.transpose(z.reshape(n, c, h, w), (0, 2, 3, 1))
    # conv_last's BN can't fold into the position-shared mix matrix
    # (per-channel scale vs channel-shared [361,361] kernel): explicit
    # affine, then the plain conv.
    v = _chain(z, [_CB(p["conv_last"], s["conv_last"])], dtype)
    return x + v


def serve_forward(model, variables, board_state, game_state,
                  want_optimistic: bool = False) -> ModelOutputs:
    """Folded, head-pruned forward pass. Returns a ModelOutputs with the
    search-consumed fields populated and training-only fields None."""
    cfg = model.config
    dtype = model.dtype
    params = variables["params"]
    stats = variables["batch_stats"]
    if not serve_supported(cfg):
        raise ValueError("serve_forward: transformer trunks use model.apply")

    board_state = board_state.astype(dtype)
    game_state = game_state.astype(dtype)

    x = _conv(board_state, params["init_board_conv"]["kernel"], dtype)
    x = x + _dense(game_state, params["init_game_layer"], dtype)[:, None, None, :]

    inner = cfg.inner_bottleneck_layers
    for i in range(cfg.blocks):
        if i % cfg.broadcast_interval == cfg.broadcast_interval - 1:
            x = _broadcast_block(x, params[f"broadcast_res_{i}"],
                                 stats[f"broadcast_res_{i}"], dtype)
        elif cfg.trunk_block_type == "btl":
            x = _btl_block(x, params[f"bottleneck_res_{i}"],
                           stats[f"bottleneck_res_{i}"], inner, dtype)
        elif cfg.trunk_block_type == "classic":
            x = _classic_block(x, params[f"classic_res_{i}"],
                               stats[f"classic_res_{i}"], 2, dtype)
        elif cfg.trunk_block_type == "nbt":
            x = _nbt_block(x, params[f"nbt_res_{i}"], stats[f"nbt_res_{i}"],
                           dtype)
        else:
            raise ValueError(cfg.trunk_block_type)

    return run_heads(params, stats, x, dtype, want_optimistic)


def run_heads(params, stats, x, dtype,
              want_optimistic: bool = False) -> ModelOutputs:
    """Search-consumed heads on a trunk output `x`."""
    # ---- policy head (heads.py PolicyHead), aux/soft skipped ----
    ph, sh = params["policy_head"], stats["policy_head"]
    n = x.shape[0]
    pco = _conv(x, ph["conv_p"]["kernel"], dtype)
    # gpool's BN reads conv_g's output directly: fold it.
    ga, gb = _affine(ph["gpool"]["batch_norm_gpool"],
                     sh["gpool"]["batch_norm_gpool"])
    g = _conv(x, ph["conv_g"]["kernel"].astype(jnp.float32) * ga, dtype,
              bias=gb)
    g = mish(g)
    g_pooled = jnp.concatenate(
        [jnp.mean(g, axis=(1, 2)), jnp.max(g, axis=(1, 2))], axis=-1)
    pco = pco + _dense(g_pooled, ph["gpool"]["Dense_0"], dtype)[:, None, None, :]
    pco = mish(pco)

    pi_board = _conv(pco, ph["output_moves"]["kernel"][..., 0:1], dtype)
    pass_logit = _dense(g_pooled, ph["output_pass"], dtype)[:, 0:1] - 3.0
    pi = jnp.concatenate([pi_board.reshape(n, -1), pass_logit], axis=1)
    pi = pi.astype(jnp.float32)

    pi_opt = None
    if want_optimistic:
        opt_board = _conv(pco, ph["optimistic_moves"]["kernel"], dtype)
        opt_pass = _dense(g_pooled, ph["optimistic_pass"], dtype) - 3.0
        pi_opt = jnp.concatenate([opt_board.reshape(n, -1), opt_pass],
                                 axis=1).astype(jnp.float32)

    # ---- value head (heads.py ValueHead), ownership/mcts_dist skipped ----
    vh = params["value_head"]
    scores = (0.05 * jnp.arange(-NUM_SCORE_LOGITS // 2, NUM_SCORE_LOGITS // 2,
                                dtype=jnp.float32) + 0.025).astype(dtype)
    v = _conv(x, vh["conv"]["kernel"], dtype)
    v_pooled = jnp.concatenate(
        [jnp.mean(v, axis=(1, 2)), jnp.max(v, axis=(1, 2))], axis=-1)

    embed = mish(_dense(v_pooled, vh["outcome_q_embed"], dtype))
    game_outcome = _dense(embed, vh["outcome_q_output"],
                          dtype).astype(jnp.float32)
    outcome_logits = game_outcome[:, 0:2]
    q6_err = 4.0 * jax.nn.sigmoid(game_outcome[:, 5])

    gamma = mish(_dense(v_pooled, vh["gamma_pre"], dtype))
    gamma = _dense(gamma, vh["gamma_output"], dtype).astype(jnp.float32)

    u = _dense(v_pooled, vh["score_pre_v"], dtype)
    w_s = vh["score_pre_s"].astype(dtype)
    hsc = mish(u[:, None, :] + scores[None, :, None] * w_s[None, :, :])
    score_logits = _dense(hsc, vh["score_output"], dtype)[..., 0]
    score_logits = (jnp.minimum(jax.nn.softplus(gamma), 10.0).astype(jnp.float32)
                    * score_logits.astype(jnp.float32))

    return ModelOutputs(
        pi_logits=pi,
        pi_probs=None,
        outcome_logits=outcome_logits,
        outcome_probs=jax.nn.softmax(outcome_logits, axis=-1),
        ownership=None,
        score_logits=score_logits,
        score_probs=jax.nn.softmax(score_logits, axis=-1),
        gamma=gamma,
        pi_logits_aux=None,
        q6=None, q16=None, q50=None,
        q6_err=q6_err, q16_err=None, q50_err=None,
        q6_score=None, q16_score=None, q50_score=None,
        q6_score_err=None, q16_score_err=None, q50_score_err=None,
        pi_logits_soft=None,
        pi_logits_optimistic=pi_opt,
        mcts_dist_logits=None,
        mcts_dist_probs=None,
    )
