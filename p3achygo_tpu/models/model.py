"""P3achyGo model (plain JAX): trunk + policy/value heads.

Mirrors python/model.py P3achyGoModel (model.py:1063-1295): 15-plane board
input + 8 scalar game-state input, init conv (conv_size+2) + game-state
bias broadcast, trunk of classic/btl/nbt blocks with broadcast blocks every
`broadcast_interval`, KataGo-style policy and value heads. All outputs are
cast to fp32 (model.py:1264-1289); trunk compute dtype is configurable
(bf16 for serving).

`P3achyGoModel` keeps the module interface its callers use:
`model.init(rng, planes, scalars)` -> {"params", "batch_stats"} and
`model.apply(variables, planes, scalars, train=..., scores=...,
mutable=["batch_stats"])` -> outputs, or (outputs, {"batch_stats": ...})
when `mutable` is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import (
    BOARD_LEN,
    NUM_INPUT_FEATURES,
    NUM_INPUT_PLANES,
)
from p3achygo_tpu.models.blocks import (
    bottleneck_block,
    broadcast_block,
    classic_block,
    nbt_block,
)
from p3achygo_tpu.models.config import ModelConfig
from p3achygo_tpu.models.heads import policy_head, value_head
from p3achygo_tpu.models.layers import Scope, conv, dense
from p3achygo_tpu.models.transformer import positional_embedding, transformer_block

Dtype = Any


class ModelOutputs(NamedTuple):
    """All model outputs, fp32 (mirrors model.py docstring outputs 0-24)."""

    pi_logits: jnp.ndarray  # [N, 362]
    pi_probs: jnp.ndarray
    outcome_logits: jnp.ndarray  # [N, 2]
    outcome_probs: jnp.ndarray
    ownership: jnp.ndarray  # [N, 361]
    score_logits: jnp.ndarray  # [N, 800]
    score_probs: jnp.ndarray
    gamma: jnp.ndarray  # [N, 1]
    pi_logits_aux: jnp.ndarray  # [N, 362]
    q6: jnp.ndarray  # [N]
    q16: jnp.ndarray
    q50: jnp.ndarray
    q6_err: jnp.ndarray
    q16_err: jnp.ndarray
    q50_err: jnp.ndarray
    q6_score: jnp.ndarray
    q16_score: jnp.ndarray
    q50_score: jnp.ndarray
    q6_score_err: jnp.ndarray
    q16_score_err: jnp.ndarray
    q50_score_err: jnp.ndarray
    pi_logits_soft: jnp.ndarray  # [N, 362]
    pi_logits_optimistic: jnp.ndarray  # [N, 362]
    mcts_dist_logits: jnp.ndarray  # [N, 51]
    mcts_dist_probs: jnp.ndarray


def _trunk(s: Scope, x, cfg: ModelConfig, dtype):
    if cfg.is_transformer:
        x = dense(s.child("embed"), x, cfg.embed_dim, dtype)
        x = positional_embedding(s.child("pos_embed"), x, dtype)
        for i in range(cfg.blocks):
            x = transformer_block(s.child(f"transformer_{i}"), x,
                                  cfg.embed_dim, cfg.num_heads, dtype)
        return x
    for i in range(cfg.blocks):
        if i % cfg.broadcast_interval == cfg.broadcast_interval - 1:
            x = broadcast_block(s.child(f"broadcast_res_{i}"), x,
                                cfg.channels, dtype)
        elif cfg.trunk_block_type == "btl":
            x = bottleneck_block(s.child(f"bottleneck_res_{i}"), x,
                                 cfg.channels, cfg.bottleneck_channels,
                                 cfg.conv_size, cfg.bottleneck_length, dtype)
        elif cfg.trunk_block_type == "classic":
            x = classic_block(s.child(f"classic_res_{i}"), x, cfg.channels,
                              cfg.conv_size, dtype)
        elif cfg.trunk_block_type == "nbt":
            x = nbt_block(s.child(f"nbt_res_{i}"), x, cfg.channels,
                          cfg.bottleneck_channels, cfg.conv_size, dtype)
        else:
            raise ValueError(cfg.trunk_block_type)
    return x


def forward(s: Scope, board_state, game_state, cfg: ModelConfig, dtype,
            scores=None) -> ModelOutputs:
    board_state = board_state.astype(dtype)
    game_state = game_state.astype(dtype)

    x = conv(s.child("init_board_conv"), board_state, cfg.channels,
             cfg.conv_size + 2, dtype)
    game_biases = dense(s.child("init_game_layer"), game_state, cfg.channels,
                        dtype)
    x = _trunk(s, x + game_biases[:, None, None, :], cfg, dtype)

    pi, pi_aux, pi_soft, pi_opt = policy_head(
        s.child("policy_head"), x, cfg.head_channels, dtype)
    vh = value_head(s.child("value_head"), x, cfg.head_channels, cfg.c_val,
                    dtype, scores)

    f32 = lambda t: t.astype(jnp.float32)
    pi, pi_aux, pi_soft, pi_opt = f32(pi), f32(pi_aux), f32(pi_soft), f32(pi_opt)
    return ModelOutputs(
        pi_logits=pi,
        pi_probs=jax.nn.softmax(pi, axis=-1),
        outcome_logits=vh["outcome_logits"],
        outcome_probs=jax.nn.softmax(vh["outcome_logits"], axis=-1),
        ownership=vh["ownership"],
        score_logits=vh["score_logits"],
        score_probs=jax.nn.softmax(vh["score_logits"], axis=-1),
        gamma=vh["gamma"],
        pi_logits_aux=pi_aux,
        q6=vh["q6"], q16=vh["q16"], q50=vh["q50"],
        q6_err=vh["q6_err"], q16_err=vh["q16_err"], q50_err=vh["q50_err"],
        q6_score=vh["q6_score"], q16_score=vh["q16_score"],
        q50_score=vh["q50_score"],
        q6_score_err=vh["q6_score_err"], q16_score_err=vh["q16_score_err"],
        q50_score_err=vh["q50_score_err"],
        pi_logits_soft=pi_soft,
        pi_logits_optimistic=pi_opt,
        mcts_dist_logits=vh["mcts_dist_logits"],
        mcts_dist_probs=jax.nn.softmax(vh["mcts_dist_logits"], axis=-1),
    )


@dataclasses.dataclass(frozen=True)
class P3achyGoModel:
    config: ModelConfig
    dtype: Dtype = jnp.float32

    def init(self, rng: jax.Array, board_state, game_state,
             train: bool = False) -> dict:
        """Create {"params", "batch_stats"} by tracing one forward pass."""
        params, stats = {}, {}
        forward(Scope(params, stats, rng=rng), board_state, game_state,
                self.config, self.dtype)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, board_state, game_state, train: bool = False,
              scores=None, mutable=False):
        stats = variables.get("batch_stats", {})
        new_stats = {} if train else None
        out = forward(Scope(variables["params"], stats, train=train,
                            new_stats=new_stats),
                      board_state, game_state, self.config, self.dtype, scores)
        if not mutable:
            return out
        return out, {"batch_stats": new_stats if train else stats}


def build_model(config: ModelConfig, dtype=jnp.float32) -> P3achyGoModel:
    return P3achyGoModel(config=config, dtype=dtype)


def init_params(model: P3achyGoModel, rng: jax.Array, batch_size: int = 1):
    """Initialize params + batch stats with dummy inputs."""
    board = jnp.zeros((batch_size, BOARD_LEN, BOARD_LEN, NUM_INPUT_PLANES),
                      jnp.float32)
    scalars = jnp.zeros((batch_size, NUM_INPUT_FEATURES), jnp.float32)
    return model.init(rng, board, scalars, train=False)
