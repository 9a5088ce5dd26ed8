"""Plain-JAX layers over a named variable tree.

A model is one function over a `Scope`. On init the scope creates each
parameter from its path-derived key; on apply it reads the tree. The
variable tree keeps the layout every checkpoint and the serving graph
(nn/serve.py) read: {"params": ..., "batch_stats": ...}, nested by layer
name, with the `Conv_0` / `BatchNorm_0` / `Dense_0` names of the model
zoo's original definition.

Numerics follow that definition: lecun-normal kernels and zero biases;
BatchNorm statistics computed in f32 with E[x^2] - E[x]^2 and running
averages at momentum 0.99; compute in the model's dtype with f32 params.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

Dtype = Any
Tree = Dict[str, Any]

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones

_DN = ("NHWC", "HWIO", "NHWC")


def _node(tree: Tree, path: Tuple[str, ...], create: bool) -> Tree:
    for k in path:
        tree = tree.setdefault(k, {}) if create else tree[k]
    return tree


class Scope:
    """Named view into {"params", "batch_stats"} at `path`.

    `rng` set: init mode, missing parameters are created. `train`: batch
    norms use batch statistics and write the updated running averages
    into `new_stats`.
    """

    def __init__(self, params: Tree, stats: Tree, *, rng=None,
                 train: bool = False, new_stats: Optional[Tree] = None,
                 path: Tuple[str, ...] = ()):
        self.params = params
        self.stats = stats
        self.rng = rng
        self.train = train
        self.new_stats = new_stats
        self.path = path

    def child(self, name: str) -> "Scope":
        return Scope(self.params, self.stats, rng=self.rng, train=self.train,
                     new_stats=self.new_stats, path=self.path + (name,))

    def param(self, name: str, init: Callable, shape) -> jnp.ndarray:
        node = _node(self.params, self.path, self.rng is not None)
        if name not in node and self.rng is not None:
            key = jax.random.fold_in(
                self.rng, zlib.crc32("/".join(self.path + (name,)).encode()))
            node[name] = init(key, tuple(shape), jnp.float32)
        return node[name]

    def stat(self, name: str, init: Callable, shape) -> jnp.ndarray:
        node = _node(self.stats, self.path, self.rng is not None)
        if name not in node and self.rng is not None:
            node[name] = init(None, tuple(shape), jnp.float32)
        return node[name]

    def set_stat(self, name: str, value: jnp.ndarray):
        _node(self.new_stats, self.path, True)[name] = value


def conv(s: Scope, x, features: int, kernel: int, dtype):
    """Bias-free 'SAME' NHWC convolution (kernel HWIO)."""
    w = s.param("kernel", lecun_normal, (kernel, kernel, x.shape[-1], features))
    return lax.conv_general_dilated(x.astype(dtype), w.astype(dtype), (1, 1),
                                    "SAME", dimension_numbers=_DN)


def dense(s: Scope, x, features: int, dtype, kernel_init=lecun_normal):
    """x @ kernel + bias over the last axis."""
    w = s.param("kernel", kernel_init, (x.shape[-1], features))
    b = s.param("bias", zeros, (features,))
    y = lax.dot_general(x.astype(dtype), w.astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    return y + b.astype(dtype)


def _moments(x, axes):
    x = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(x, axes)
    var = jnp.maximum(0.0, jnp.mean(x * x, axes) - mean * mean)
    return mean, var


def _scale_shift(s: Scope, x, mean, var, eps: float, dtype):
    c = x.shape[-1]
    y = x - mean
    mul = lax.rsqrt(var + eps) * s.param("scale", ones, (c,))
    return ((y * mul) + s.param("bias", zeros, (c,))).astype(dtype)


def batch_norm(s: Scope, x, dtype, momentum: float = 0.99,
               eps: float = 1e-3):
    """BatchNorm over every axis but the channels."""
    c = x.shape[-1]
    ra_mean = s.stat("mean", zeros, (c,))
    ra_var = s.stat("var", ones, (c,))
    if s.train:
        mean, var = _moments(x, tuple(range(x.ndim - 1)))
        s.set_stat("mean", momentum * ra_mean + (1 - momentum) * mean)
        s.set_stat("var", momentum * ra_var + (1 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    return _scale_shift(s, x, mean, var, eps, dtype)


def layer_norm(s: Scope, x, dtype, eps: float = 1e-6):
    mean, var = _moments(x, (-1,))
    return _scale_shift(s, x, mean[..., None], var[..., None], eps, dtype)


def _dense_general(s: Scope, x, in_shape, out_shape, dtype, spec: str):
    """Dense with several in/out axes; the kernel is lecun-normal over its
    flattened (prod(in_shape), prod(out_shape)) matrix."""
    def init(key, shape, dt):
        flat = (math.prod(in_shape), math.prod(out_shape))
        return lecun_normal(key, flat, dt).reshape(shape)

    w = s.param("kernel", init, tuple(in_shape) + tuple(out_shape))
    b = s.param("bias", zeros, tuple(out_shape))
    return jnp.einsum(spec, x.astype(dtype), w.astype(dtype)) + b.astype(dtype)


def self_attention(s: Scope, x, num_heads: int, qkv_features: int, dtype):
    """Multi-head self-attention over tokens x [N, T, C]; per-head
    query/key/value/out projections ([C, heads, head_dim] kernels)."""
    c = x.shape[-1]
    hd = qkv_features // num_heads
    q, k, v = (_dense_general(s.child(n), x, (c,), (num_heads, hd), dtype,
                              "ntc,chd->nthd")
               for n in ("query", "key", "value"))
    y = jax.nn.dot_product_attention(q, k, v)
    return _dense_general(s.child("out"), y, (num_heads, hd), (c,), dtype,
                          "nthd,hdc->ntc")
