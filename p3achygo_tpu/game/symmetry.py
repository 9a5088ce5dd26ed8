"""D4 symmetry group on board grids and move indices.

Mirrors cc/game/symmetry.{h,cc} (enum at symmetry.h:12-21) and
python/symmetry.py, as precomputed index-permutation tables so applying a
(possibly per-example random) symmetry is a single gather — vmappable over a
batch of boards with per-board symmetry choices.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import BOARD_LEN, NUM_LOCS, NUM_MOVES, PASS_MOVE

IDENTITY = 0
ROT90 = 1
ROT180 = 2
ROT270 = 3
FLIP = 4  # flip across vertical line
FLIP_ROT90 = 5
FLIP_ROT180 = 6
FLIP_ROT270 = 7
NUM_SYMMETRIES = 8


def _transform_grid(g: np.ndarray, sym: int) -> np.ndarray:
    """Apply symmetry to a [19, 19] grid (numpy, build-time only)."""
    if sym >= FLIP:
        g = g[:, ::-1]
        sym -= FLIP
    return np.rot90(g, k=sym)


def _build_tables():
    idx = np.arange(NUM_LOCS).reshape(BOARD_LEN, BOARD_LEN)
    fwd = np.zeros((NUM_SYMMETRIES, NUM_LOCS), np.int32)
    inv = np.zeros((NUM_SYMMETRIES, NUM_LOCS), np.int32)
    for s in range(NUM_SYMMETRIES):
        t = _transform_grid(idx, s).reshape(-1)
        # t[new_pos] = old_pos: transformed_grid[new] = grid[t[new]]
        fwd[s] = t
        inv[s][t] = np.arange(NUM_LOCS)
    return fwd, inv


_FWD_NP, _INV_NP = _build_tables()
# SYM_GATHER[s, p] = source index: apply(grid, s)[p] = grid[SYM_GATHER[s, p]]
SYM_GATHER = jnp.asarray(_FWD_NP)
# SYM_SCATTER[s, p] = destination index of point p under symmetry s
SYM_SCATTER = jnp.asarray(_INV_NP)


def apply_symmetry_grid(grid: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    """Transform a flat [..., 361] grid by symmetry `sym` (scalar)."""
    return jnp.take(grid, SYM_GATHER[sym], axis=-1)


def apply_symmetry_grid_batch(grid: jnp.ndarray,
                              sym: jnp.ndarray) -> jnp.ndarray:
    """Per-board D4 transform of [B, 361] grids (any dtype), batched.

    Decomposes each symmetry into flip/transpose selects instead of a
    per-example gather or an 8-way one-hot
    gather accumulation (8x the array traffic): col-flip if sym >= 4,
    then rot90^k as (transpose if k odd, row-flip if k in {1,2},
    col-flip if k in {2,3}) — exactly _transform_grid's convention, so
    the result matches apply_symmetry_grid(grid[i], sym[i]) row-wise.
    """
    B = grid.shape[0]
    g = grid.reshape(B, BOARD_LEN, BOARD_LEN)
    k = sym % 4
    g = jnp.where((sym >= 4)[:, None, None], g[:, :, ::-1], g)
    gt = jnp.swapaxes(g, 1, 2)
    g = jnp.where((k % 2 == 1)[:, None, None], gt, g)
    g = jnp.where(((k == 1) | (k == 2))[:, None, None], g[:, ::-1, :], g)
    g = jnp.where(((k == 2) | (k == 3))[:, None, None], g[:, :, ::-1], g)
    return g.reshape(B, NUM_LOCS)


def apply_inverse_grid(grid: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(grid, SYM_SCATTER[sym], axis=-1)


def apply_symmetry_action(action: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    """Transform a move encoding (0..361; pass/noop fixed points)."""
    a = jnp.clip(action, 0, NUM_LOCS - 1)
    mapped = SYM_SCATTER[sym, a]
    return jnp.where((action >= 0) & (action < NUM_LOCS), mapped, action)


def apply_inverse_action(action: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    a = jnp.clip(action, 0, NUM_LOCS - 1)
    mapped = SYM_GATHER[sym, a]
    return jnp.where((action >= 0) & (action < NUM_LOCS), mapped, action)


def apply_symmetry_policy(policy: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    """Transform a [..., 362] policy vector (pass logit untouched)."""
    board_part = jnp.take(policy[..., :NUM_LOCS], SYM_GATHER[sym], axis=-1)
    return jnp.concatenate([board_part, policy[..., NUM_LOCS:]], axis=-1)


def apply_inverse_policy(policy: jnp.ndarray, sym: jnp.ndarray) -> jnp.ndarray:
    board_part = jnp.take(policy[..., :NUM_LOCS], SYM_SCATTER[sym], axis=-1)
    return jnp.concatenate([board_part, policy[..., NUM_LOCS:]], axis=-1)
