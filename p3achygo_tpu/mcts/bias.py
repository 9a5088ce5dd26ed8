"""Local-pattern value-bias cache (cc/mcts/bias_cache.h:16-205).

KataGo-style observed-bias correction: positions sharing the same 5x5
local pattern around the last move (stones + atari map + illegal/ko map,
plus the last two moves and mover color) share a cache entry tracking the
NN's observed value error there, and fresh evaluations of matching
patterns are corrected by lambda * (weighted error / weighted visits).

Array design: a per-board open-addressed device table (same machinery as
tree.McgsTable) keyed by two 32-bit pattern-hash lanes. Leaves FETCH
their correction at creation (probe + payload read via exact one-hot
contractions); the error statistics are ACCUMULATED once at the END of
each search from node aggregates — obs_err = init_util -
weighted_child_utility/(n-1) with weighted_child_utility = -sum(edge_w)
(edge sums are the child-perspective w), weight = (n-1)^alpha, delta'd
against the node's last contribution so tree reuse never double-counts
(bias_cache.h:155-185 UpdateAndFetch, telescoped per search instead of
per backup — a documented deviation; the reference's per-backup
idempotent recompute would serialize here).

Like the reference, the feature is OFF by default
(bias_cache_lambda = 0.0, selfplay/main.cc:58).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import BLACK, BOARD_LEN, EMPTY, NUM_LOCS, WHITE

PATTERN_LEN = 5
_HALF = PATTERN_LEN // 2
# state encoding inside the pattern (bias_cache.h:33-39):
# EMPTY=0 (hash 0), BLACK=1, OFF_BOARD=2, WHITE=3
_NUM_STATES = 4

_rng = np.random.default_rng(0xB1A5)
# [5, 5, 4, 2-lane] zobrist; EMPTY rows are zero.
_PZ = _rng.integers(0, 1 << 32, (PATTERN_LEN, PATTERN_LEN, _NUM_STATES, 2),
                    dtype=np.uint32)
_PZ[:, :, EMPTY, :] = 0
_PZ_GRID = jnp.asarray(_PZ)
_PZ_ATARI = jnp.asarray(np.roll(_PZ, 7, axis=3) ^ np.uint32(0x9E3779B9))
_PZ_KO = jnp.asarray(np.roll(_PZ, 13, axis=3) ^ np.uint32(0x85EBCA6B))
# arithmetic mixing constants for (last move, two-moves-ago, color)
_C_LAST = jnp.uint32(2654435761)
_C_PREV = jnp.uint32(2246822519)
_C_COLOR = jnp.uint32(3266489917)


class BiasTable(NamedTuple):
    """Open-addressed per-board pattern table [B, S] (S = power of two)."""

    key0: jnp.ndarray  # uint32[B, S]
    key1: jnp.ndarray  # uint32[B, S]
    used: jnp.ndarray  # int8[B, S] 0 = empty
    err_sum: jnp.ndarray  # f32[B, S] weighted observed error
    w_sum: jnp.ndarray  # f32[B, S] weighted visits


BIAS_PROBES = 4


def make_bias_table(batch_size: int, size: int = 1024) -> BiasTable:
    assert size & (size - 1) == 0
    return BiasTable(
        key0=jnp.zeros((batch_size, size), jnp.uint32),
        key1=jnp.zeros((batch_size, size), jnp.uint32),
        used=jnp.zeros((batch_size, size), jnp.int8),
        err_sum=jnp.zeros((batch_size, size), jnp.float32),
        w_sum=jnp.zeros((batch_size, size), jnp.float32),
    )


def _window_values(grid_flat: jnp.ndarray, center: jnp.ndarray,
                   off_board_val: int) -> jnp.ndarray:
    """[W, 361] per-lane grids + [W] centers -> [W, 25] 5x5 window values.

    Static shifted-slice dot products against the center one-hot instead
    of per-lane window gathers.
    """
    W = grid_flat.shape[0]
    g = grid_flat.reshape(W, BOARD_LEN, BOARD_LEN).astype(jnp.float32)
    pad = jnp.pad(g, ((0, 0), (_HALF, _HALF), (_HALF, _HALF)),
                  constant_values=float(off_board_val))
    ci = jnp.clip(center, 0, NUM_LOCS - 1)
    oh = jax.nn.one_hot(ci, NUM_LOCS, dtype=jnp.float32).reshape(
        W, BOARD_LEN, BOARD_LEN)
    outs = []
    for di in range(PATTERN_LEN):
        for dj in range(PATTERN_LEN):
            sl = pad[:, di:di + BOARD_LEN, dj:dj + BOARD_LEN]
            outs.append(jnp.sum(oh * sl, axis=(1, 2)))
    return jnp.stack(outs, axis=-1)  # [W, 25]


def _xor_select(vals: jnp.ndarray, ztab: jnp.ndarray) -> jnp.ndarray:
    """[W, 25] small-int states -> XOR of ztab[off, state] -> uint32[W, 2]."""
    W = vals.shape[0]
    v = vals.astype(jnp.int32)
    h = jnp.zeros((W, 2), jnp.uint32)
    flat_z = ztab.reshape(PATTERN_LEN * PATTERN_LEN, _NUM_STATES, 2)
    for off in range(PATTERN_LEN * PATTERN_LEN):
        s = v[:, off]
        # exact 4-way select (states 0..3); where-chain, no gather
        z = jnp.where(
            (s == 1)[:, None], flat_z[off, 1],
            jnp.where((s == 2)[:, None], flat_z[off, 2],
                      jnp.where((s == 3)[:, None], flat_z[off, 3],
                                jnp.zeros((2,), jnp.uint32))))
        h = h ^ z
    return h


def local_pattern_keys(stones: jnp.ndarray, atari: jnp.ndarray,
                       illegal_empty: jnp.ndarray, last_moves: jnp.ndarray,
                       to_move: jnp.ndarray):
    """Per-lane pattern keys (LocalPattern::FromCurrentPosition,
    bias_cache.h:63-118).

    stones int8[W, 361]; atari bool[W, 361] (chain libs == 1);
    illegal_empty bool[W, 361] (empty AND not legal for the side to move —
    the reference's ko map); last_moves int32[W, 5] (oldest..newest).
    Returns (h0, h1, valid) with valid False when the last move is a
    pass/noop or the move before it is a noop.
    """
    last = last_moves[:, -1]
    prev = last_moves[:, -2]
    valid = (last >= 0) & (last < NUM_LOCS) & (prev != -1)

    # grid states: EMPTY 0, BLACK 1, OFF_BOARD 2 (via padding), WHITE 3
    grid = jnp.where(stones == BLACK, 1,
                     jnp.where(stones == WHITE, 3, 0)).astype(jnp.int8)
    gv = _window_values(grid, last, off_board_val=2)
    av = _window_values(atari.astype(jnp.int8), last, off_board_val=0)
    kv = _window_values(illegal_empty.astype(jnp.int8), last,
                        off_board_val=0)
    h = _xor_select(gv, _PZ_GRID) ^ _xor_select(av, _PZ_ATARI) \
        ^ _xor_select(kv, _PZ_KO)
    # fold last/prev moves + mover color in (arithmetic mixing; the
    # reference keys the map on these fields directly)
    lastu = last.astype(jnp.uint32)
    prevu = jnp.clip(prev, 0, NUM_LOCS).astype(jnp.uint32)
    # color of the LAST move = opponent of the side to move now
    colu = jnp.where(to_move == BLACK, jnp.uint32(2), jnp.uint32(1))
    h0 = h[:, 0] ^ (lastu * _C_LAST) ^ (colu * _C_COLOR)
    h1 = h[:, 1] ^ (prevu * _C_PREV) ^ (colu * _C_COLOR)
    return h0, h1, valid


def _slots(h0, h1, size):
    base = (h0 ^ (h1 * jnp.uint32(2654435761))).astype(jnp.uint32)
    offs = jnp.arange(BIAS_PROBES, dtype=jnp.uint32)[None, :]
    return ((base[:, None] + offs) & jnp.uint32(size - 1)).astype(jnp.int32)


def bias_probe(table: BiasTable, k_r: int, h0, h1, valid):
    """Lookup W = B*k_r lanes (lanes b-major) -> (bias_num [W],
    bias_den [W], slot [W], can_insert [W]).

    `slot` is the matching slot if found, else the first empty probed
    slot; can_insert says some usable slot exists.
    """
    B, S = table.key0.shape
    W = h0.shape[0]
    slots = _slots(h0, h1, S)
    oh = jax.nn.one_hot(slots, S, dtype=jnp.float32).reshape(
        B, k_r * BIAS_PROBES, S)
    gsel = lambda arr: jnp.einsum(
        "bps,bs->bp", oh, arr.astype(jnp.float32),
        preferred_element_type=jnp.float32).reshape(W, BIAS_PROBES)
    g_k0lo = gsel(table.key0 & jnp.uint32(0xFFFF))
    g_k0hi = gsel(table.key0 >> jnp.uint32(16))
    g_k1lo = gsel(table.key1 & jnp.uint32(0xFFFF))
    g_k1hi = gsel(table.key1 >> jnp.uint32(16))
    g_used = gsel(table.used)
    g_err = gsel(table.err_sum)
    g_w = gsel(table.w_sum)

    q = lambda x: x.astype(jnp.float32)[:, None]
    hit_p = ((g_used > 0.5)
             & (g_k0lo == q(h0 & jnp.uint32(0xFFFF)))
             & (g_k0hi == q(h0 >> jnp.uint32(16)))
             & (g_k1lo == q(h1 & jnp.uint32(0xFFFF)))
             & (g_k1hi == q(h1 >> jnp.uint32(16))))
    first_hit = hit_p & (jnp.cumsum(hit_p, axis=1) == 1)
    hit = jnp.any(hit_p, axis=1) & valid
    empty_p = g_used < 0.5
    first_empty = empty_p & (jnp.cumsum(empty_p, axis=1) == 1)
    pick = jnp.where(jnp.any(hit_p, axis=1)[:, None], first_hit, first_empty)
    slot = jnp.sum(jnp.where(pick, slots, 0), axis=1)
    can = (jnp.any(hit_p, axis=1) | jnp.any(empty_p, axis=1)) & valid
    num = jnp.where(hit, jnp.sum(jnp.where(first_hit, g_err, 0.0), axis=1),
                    0.0)
    den = jnp.where(hit, jnp.sum(jnp.where(first_hit, g_w, 0.0), axis=1),
                    0.0)
    return num, den, slot, can


def bias_fetch(table: BiasTable, k_r: int, h0, h1, valid,
               lam: float) -> jnp.ndarray:
    """lambda * err_sum / w_sum for matching patterns, else 0
    (BiasCache::Fetch, bias_cache.h:188-193)."""
    num, den, _, _ = bias_probe(table, k_r, h0, h1, valid)
    return jnp.where(den > 0, lam * num / jnp.maximum(den, 1e-9), 0.0)


def bias_accumulate(table: BiasTable, slot_bn: jnp.ndarray,
                    valid_bn: jnp.ndarray, key0_bn, key1_bn,
                    d_err_bn: jnp.ndarray, d_w_bn: jnp.ndarray) -> BiasTable:
    """End-of-search accumulation: per-NODE deltas [B, N] routed to their
    pattern slots via a one-hot contraction (scatter-add over per-row
    indices would serialize). Inserts keys for newly-used slots."""
    B, S = table.key0.shape
    oh = jax.nn.one_hot(jnp.where(valid_bn, slot_bn, S), S,
                        dtype=jnp.float32)  # [B, N, S]; invalid -> zero row
    add = lambda d: jnp.einsum("bns,bn->bs", oh, d,
                               preferred_element_type=jnp.float32)
    err_sum = table.err_sum + add(d_err_bn)
    w_sum = table.w_sum + add(d_w_bn)
    # Mark slots used + write keys (first writer wins on conflicts).
    bw = jnp.repeat(jnp.arange(B), slot_bn.shape[1])
    sl = jnp.where(valid_bn, slot_bn, S).reshape(-1)
    k0 = key0_bn.reshape(-1)
    k1 = key1_bn.reshape(-1)
    used = table.used.at[bw, sl].set(jnp.int8(1), mode="drop")
    key0 = table.key0.at[bw, sl].set(k0, mode="drop")
    key1 = table.key1.at[bw, sl].set(k1, mode="drop")
    return BiasTable(key0=key0, key1=key1, used=used, err_sum=err_sum,
                     w_sum=w_sum)
