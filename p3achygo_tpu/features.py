"""NN input featurizer (v1): 15 planes + 8 scalars.

Mirrors cc/nn/engine/go_features.cc:10-62 exactly:
  planes 0/1   own/opp stones
  planes 2-6   last-5-move one-hots (oldest..newest; pass/noop skipped)
  planes 7/8   own/opp stones in atari (1 liberty)
  planes 9/10  own/opp stones with 2 liberties
  planes 11/12 own/opp stones with 3 liberties
  planes 13/14 own/opp laddered stones (v1)
  scalars: [own==B, own==W, pass flags for last-5 moves, signed komi/15]

Single-state function; vmap for batches. Output layout is NHWC
([19, 19, 15]) so convs read it without transposes.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import (
    BLACK,
    BOARD_LEN,
    NUM_INPUT_FEATURES,
    NUM_INPUT_PLANES,
    NUM_LAST_MOVES,
    NUM_LOCS,
    WHITE,
)
from p3achygo_tpu.game.board import GoState, point_liberties, point_liberties_batch
from p3achygo_tpu.game.ladder import laddered_stones


def features(state: GoState, include_ladders: bool = True,
             libs: jnp.ndarray = None, planes_dtype=jnp.float32
             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (planes planes_dtype[19, 19, 15], scalars float32[8]) for
    state.to_move.

    `libs` optionally supplies precomputed per-point chain liberty counts
    (the batched caller computes them with the Pallas kernel).
    `planes_dtype`: all plane values are 0/1 — exact in bf16 — and the
    model casts to its compute dtype anyway, so the serving path requests
    bf16 to halve the [W,361,15] featurizer HBM stream.
    """
    c = state.to_move
    stones = state.stones
    own = (stones == c).astype(planes_dtype)
    opp = (stones == (-c)).astype(planes_dtype)

    if libs is None:
        libs = point_liberties(stones, state.chain_id)

    def pair(mask):
        m = mask.astype(planes_dtype)
        return own * m, opp * m

    atari_own, atari_opp = pair(libs == 1)
    two_own, two_opp = pair(libs == 2)
    three_own, three_opp = pair(libs == 3)

    if include_ladders:
        lad = laddered_stones(state)
        lad_own, lad_opp = pair(lad)
    else:
        lad_own = jnp.zeros((NUM_LOCS,), planes_dtype)
        lad_opp = jnp.zeros((NUM_LOCS,), planes_dtype)

    # last-move one-hot planes (channel i+2 = i-th oldest of the last 5).
    mv = state.last_moves  # int32[5]; -1 noop, 361 pass
    on_board = (mv >= 0) & (mv < NUM_LOCS)
    onehots = (
        (jnp.arange(NUM_LOCS)[None, :] == jnp.clip(mv, 0, NUM_LOCS - 1)[:, None])
        & on_board[:, None]
    ).astype(planes_dtype)  # [5, 361]

    planes = jnp.stack(
        [
            own, opp,
            onehots[0], onehots[1], onehots[2], onehots[3], onehots[4],
            atari_own, atari_opp,
            two_own, two_opp,
            three_own, three_opp,
            lad_own, lad_opp,
        ],
        axis=-1,
    )  # [361, 15]
    planes = planes.reshape(BOARD_LEN, BOARD_LEN, NUM_INPUT_PLANES)

    is_black = (c == BLACK).astype(jnp.float32)
    pass_flags = (mv == NUM_LOCS).astype(jnp.float32)  # [5]
    komi_feat = jnp.where(c == BLACK, -1.0, 1.0) * state.komi / 15.0
    scalars = jnp.concatenate(
        [is_black[None], (1.0 - is_black)[None], pass_flags, komi_feat[None]])
    return planes, scalars


def batched_features(states: GoState, include_ladders: bool = False,
                     planes_dtype=jnp.float32
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """[B] states -> (planes [B,19,19,15], scalars [B,8]) from one
    batched liberty pass."""
    libs = point_liberties_batch(states.stones, states.chain_id)
    return jax.vmap(
        lambda s, l: features(s, include_ladders, l, planes_dtype)
    )(states, libs)
