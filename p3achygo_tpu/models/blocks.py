"""Trunk building blocks (plain JAX over models/layers.Scope).

Mirrors python/model.py's layer zoo (ConvBlock/make_conv_block at
model.py:203-296, ClassicResidualBlock:330, BottleneckResidualConvBlock:372,
NbtResidualBlock:431, BroadcastResidualBlock:490, GlobalPool:634,
GlobalPoolBias:664) with pre-activation BN+mish conv blocks in NHWC.

Compute dtype is configurable (bf16 for serving); params and BN stats stay
fp32. Each block takes the Scope of its own name; sub-layer names are the
variable tree's keys (nn/serve.py reads them).
"""
from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from p3achygo_tpu.models.layers import Scope, batch_norm, conv, dense

Dtype = Any


def mish(x):
    """mish(x) = x * tanh(softplus(x)), ONE transcendental and NO select.

    tanh(log(1 + e^x)) = ((1+e^x)^2 - 1) / ((1+e^x)^2 + 1)
                       = (u^2 + 2u) / (u^2 + 2u + 2),  u = e^x.
    Clamping the exponent input at 20 keeps u^2 finite (e^40 << f32 max)
    and is exact: for x > 20 the ratio is 1 - 2e^-20 which rounds to 1.0f,
    i.e. mish(x) == x there anyway. For x -> -inf, u -> 0 and the ratio
    -> 0. A single rational in u, with no select, fuses into the
    neighbouring convolution's elementwise prologue.
    """
    u = jnp.exp(jnp.minimum(x, 20.0))
    n = u * u + 2.0 * u
    return x * n / (n + 2.0)


def conv_block(s: Scope, x, features: int, kernel: int, dtype):
    """Pre-activation conv: BN -> mish -> 2D conv (bias-free).

    Matches make_conv_block (model.py:287-296): ConvPreActivation with
    BatchNorm(momentum=0.99, eps=1e-3).
    """
    x = batch_norm(s.child("BatchNorm_0"), x, dtype)
    return conv(s.child("Conv_0"), mish(x), features, kernel, dtype)


def classic_block(s: Scope, x, features: int, conv_size: int, dtype,
                  stack_size: int = 2):
    """x + conv(conv(x)) (model.py:330-371)."""
    res = x
    for i in range(stack_size):
        x = conv_block(s.child(f"conv_{i}"), x, features, conv_size, dtype)
    return res + x


def bottleneck_block(s: Scope, x, features: int, bottleneck: int,
                     conv_size: int, stack_size: int, dtype):
    """1x1 reduce -> (stack_size-2) KxK convs -> 1x1 expand, residual
    (model.py:372-430)."""
    res = x
    x = conv_block(s.child("reduce"), x, bottleneck, 1, dtype)
    for i in range(stack_size - 2):
        x = conv_block(s.child(f"inner_{i}"), x, bottleneck, conv_size, dtype)
    x = conv_block(s.child("expand"), x, features, 1, dtype)
    return res + x


def nbt_block(s: Scope, x, features: int, bottleneck: int, conv_size: int,
              dtype):
    """Nested bottleneck (KataGo-style, model.py:431-489): 1x1 reduce ->
    2 classic residual blocks at bottleneck width -> 1x1 expand, residual."""
    res = x
    x = conv_block(s.child("reduce"), x, bottleneck, 1, dtype)
    x = classic_block(s.child("nbt_res0"), x, bottleneck, conv_size, dtype)
    x = classic_block(s.child("nbt_res1"), x, bottleneck, conv_size, dtype)
    x = conv_block(s.child("expand"), x, features, 1, dtype)
    return res + x


def broadcast_mix(s: Scope, x, dtype):
    """Per-channel global mix: dense over the flattened 361 spatial dims
    (model.py:509-581 BroadcastPreAct: act -> flatten -> dense -> expand)."""
    n, h, w, c = x.shape
    x = mish(x)
    x = jnp.transpose(x, (0, 3, 1, 2)).reshape(n, c, h * w)
    x = dense(s.child("Dense_0"), x, h * w, dtype)
    x = x.reshape(n, c, h, w)
    return jnp.transpose(x, (0, 2, 3, 1))


def broadcast_block(s: Scope, x, features: int, dtype):
    """1x1 conv -> broadcast mix -> 1x1 conv, residual (model.py:583-625)."""
    res = x
    x = conv_block(s.child("conv_first"), x, features, 1, dtype)
    x = broadcast_mix(s.child("mix"), x, dtype)
    x = conv_block(s.child("conv_last"), x, features, 1, dtype)
    return res + x


def global_pool(x):
    """[N, H, W, C] -> [N, 2C]: concat(mean, max) per channel
    (model.py:634-652)."""
    return jnp.concatenate([jnp.mean(x, axis=(1, 2)), jnp.max(x, axis=(1, 2))],
                           axis=-1)


def global_pool_bias(s: Scope, x, g, channels: int, dtype):
    """x + dense(gpool(BN(mish(g)))) channelwise; returns (x, g_pooled)
    (model.py:655-724)."""
    g = mish(batch_norm(s.child("batch_norm_gpool"), g, dtype))
    g_pooled = global_pool(g)
    biases = dense(s.child("Dense_0"), g_pooled, channels, dtype)
    return x + biases[:, None, None, :], g_pooled
