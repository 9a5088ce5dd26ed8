"""Batches of random mid-game positions, for tests and on-device checks."""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import NUM_LOCS
from p3achygo_tpu.game.board import GoState, legal_mask_batch, new_state, step


@partial(jax.jit, static_argnames=("n", "max_ply"))
def random_positions(key, n: int, max_ply: int) -> GoState:
    """`n` positions from uniformly random legal playouts, each stopped at
    its own ply drawn from [max_ply // 10, max_ply]. A board with no legal
    point passes."""
    k_ply, key = jax.random.split(key)
    stop = jax.random.randint(k_ply, (n,), max_ply // 10, max_ply + 1)
    states = jax.vmap(lambda _: new_state(7.5))(jnp.arange(n))

    def body(i, carry):
        st, k = carry
        k, ks = jax.random.split(k)
        board_legal = legal_mask_batch(st)[:, :NUM_LOCS]
        mv = jax.random.categorical(ks, jnp.where(board_legal, 0.0, -1e9))
        mv = jnp.where(board_legal.any(-1), mv, NUM_LOCS).astype(jnp.int32)
        nxt, _ = jax.vmap(step)(st, mv)
        live = i < stop
        st = jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                live.reshape((n,) + (1,) * (a.ndim - 1)), a, b), nxt, st)
        return st, k

    return jax.lax.fori_loop(0, max_ply, body, (states, key))[0]
