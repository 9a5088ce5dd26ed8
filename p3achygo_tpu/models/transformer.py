"""Transformer trunk block (mirrors python/model_transformer.py).

361 board points as tokens with learned 2D positional embeddings; pre-LN
self-attention + MLP. Single-device at 361 tokens (no sequence sharding
needed, SURVEY.md §5 long-context note); attention runs as
[N, heads, 361, 361] batched matmuls.
"""
from __future__ import annotations

import jax

from p3achygo_tpu.models.layers import Scope, dense, layer_norm, self_attention


def transformer_block(s: Scope, x, embed_dim: int, num_heads: int, dtype,
                      mlp_ratio: int = 4):
    # x: [N, H, W, C] -> tokens [N, HW, C]
    n, h, w, c = x.shape
    t = x.reshape(n, h * w, c)
    y = layer_norm(s.child("LayerNorm_0"), t, dtype)
    t = t + self_attention(s.child("MultiHeadDotProductAttention_0"), y,
                           num_heads, embed_dim, dtype)
    y = layer_norm(s.child("LayerNorm_1"), t, dtype)
    y = jax.nn.gelu(dense(s.child("Dense_0"), y, mlp_ratio * c, dtype))
    t = t + dense(s.child("Dense_1"), y, c, dtype)
    return t.reshape(n, h, w, c)


def positional_embedding(s: Scope, x, dtype):
    """Learned additive 2D positional embedding."""
    _, h, w, c = x.shape
    pos = s.param("pos_embed", jax.nn.initializers.normal(0.02), (h, w, c))
    return x + pos.astype(dtype)
