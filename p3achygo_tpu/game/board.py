"""Vectorized, jit-able Go rules engine.

Array-program replacement for the reference's sequential C++ engine
(cc/game/board.{h,cc}: GroupTracker, capture resolution, positional superko
via seen-hash set at board.cc:637-639, self-capture ban board.cc:900-914,
area scoring board.cc:916-988). Instead of incremental DFS group tracking,
every board op is a fixed-shape array program over a [361] lattice:

- Chains are identified by a representative point index (`chain_id`); merging
  on stone placement is O(1) vectorized compares against the <=4 neighbor
  chain reps — no loops, no data-dependent shapes.
- Chain liberty counts are recomputed per move with a 4-way deduplicated
  scatter-add (one pass over the lattice), rather than maintained with
  sequential bookkeeping.
- Positional superko uses an additive 64-bit (2x uint32 lane) Zobrist hash
  and a fixed-capacity seen-hash ring, checked exactly for the played move.
  (Additive rather than XOR so per-chain hash deltas are segment-sums,
  which XLA scatters natively.)
- The cheap per-move legality mask covers empty/suicide/simple-ko; the exact
  mask (incl. full positional superko for all 361 points, mirroring
  PlayMoveDry board.cc:595-644) is a separate vmapped dry-run used at
  game-move time, by tests, and by GTP.

All functions below operate on a single board and are `jax.vmap`-ed for the
batch axis; under vmap every op stays dense and fixed-shape so thousands of
boards step in lockstep on one device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import (
    BLACK,
    BOARD_LEN,
    DEFAULT_KOMI,
    EMPTY,
    MAX_HISTORY,
    NOOP_MOVE,
    NUM_LAST_MOVES,
    NUM_LOCS,
    NUM_MOVES,
    PASS_MOVE,
    WHITE,
)

# ----------------------------------------------------------------------------
# Move status codes (mirror cc/game/board.h:54-66 MoveStatus).
# ----------------------------------------------------------------------------
MOVE_VALID = 0
MOVE_UNKNOWN_COLOR = 1
MOVE_OUT_OF_BOUNDS = 2
MOVE_LOC_NOT_EMPTY = 3
MOVE_SELF_CAPTURE = 4
MOVE_REPEATED_POSITION = 5
MOVE_PASS_ALIVE_REGION = 6

_SENTINEL = NUM_LOCS  # padded gather slot for off-board neighbors


def _build_neighbors() -> np.ndarray:
    """[361, 4] neighbor point indices; off-board -> sentinel 361."""
    nbrs = np.full((NUM_LOCS, 4), _SENTINEL, dtype=np.int32)
    for i in range(BOARD_LEN):
        for j in range(BOARD_LEN):
            p = i * BOARD_LEN + j
            if i > 0:
                nbrs[p, 0] = (i - 1) * BOARD_LEN + j
            if i < BOARD_LEN - 1:
                nbrs[p, 1] = (i + 1) * BOARD_LEN + j
            if j > 0:
                nbrs[p, 2] = i * BOARD_LEN + (j - 1)
            if j < BOARD_LEN - 1:
                nbrs[p, 3] = i * BOARD_LEN + (j + 1)
    return nbrs


NEIGHBORS = jnp.asarray(_build_neighbors())

# Additive Zobrist table: [NUM_LOCS + 1, 3 states, 2 lanes] uint32. The extra
# sentinel row stays zero so padded gathers are harmless. State index is
# stones + 1: WHITE=0, EMPTY=1, BLACK=2. Reference: cc/game/zobrist.{h,cc}
# (128-bit XOR table); additive 64-bit is equivalent for superko membership.
_ZOB_RNG = np.random.default_rng(0x9E3779B97F4A7C15 % (2**32))
_ZOB = _ZOB_RNG.integers(0, 2**32, size=(NUM_LOCS + 1, 3, 2), dtype=np.uint64)
_ZOB[_SENTINEL] = 0
ZOBRIST = jnp.asarray(_ZOB.astype(np.uint32))

_IOTA = jnp.arange(NUM_LOCS, dtype=jnp.int32)


class GoState(NamedTuple):
    """Complete single-board game state. Batch via jax.vmap."""

    stones: jnp.ndarray  # int8[361] in {0, 1, -1}
    chain_id: jnp.ndarray  # int32[361]; rep point index for stones, -1 empty
    hash: jnp.ndarray  # uint32[2] additive zobrist of current position
    history: jnp.ndarray  # uint32[MAX_HISTORY, 2] seen-position ring
    history_len: jnp.ndarray  # int32
    last_moves: jnp.ndarray  # int32[5], oldest..newest; -1 noop, 361 pass
    to_move: jnp.ndarray  # int8, BLACK or WHITE
    ko_point: jnp.ndarray  # int32, simple-ko point for opponent, -1 none
    consecutive_passes: jnp.ndarray  # int32
    passes: jnp.ndarray  # int32 total passes
    move_count: jnp.ndarray  # int32
    komi: jnp.ndarray  # float32
    num_b_prisoners: jnp.ndarray  # int32 black stones captured by white
    num_w_prisoners: jnp.ndarray  # int32 white stones captured by black
    # Benson pass-alive region map {0, BLACK, WHITE} (GroupTracker
    # pass_alive_, board.h:246-248): moves at non-empty entries are illegal
    # for BOTH colors (board.cc:607-608 kPassAliveRegion). Refreshed
    # OUTSIDE step() at the reference's checkpoints (scoring.py
    # refresh_pass_alive); carried unchanged through moves, exactly like
    # the reference's lazily-recomputed map.
    pass_alive: jnp.ndarray  # int8[361]
    pa_move: jnp.ndarray  # int32 move_count at last pass-alive refresh


def _pad(x: jnp.ndarray, fill) -> jnp.ndarray:
    """Append a sentinel slot so NEIGHBORS gathers are branch-free."""
    return jnp.concatenate([x, jnp.full((1,), fill, dtype=x.dtype)])


def compute_hash(stones: jnp.ndarray) -> jnp.ndarray:
    """Additive zobrist over the full position -> uint32[2]."""
    idx = (stones.astype(jnp.int32) + 1)  # WHITE->0 EMPTY->1 BLACK->2
    z = ZOBRIST[:NUM_LOCS]  # [361, 3, 2]
    picked = jnp.take_along_axis(z, idx[:, None, None], axis=1)[:, 0, :]
    return jnp.sum(picked.astype(jnp.uint32), axis=0, dtype=jnp.uint32)


def chain_lib_counts(stones: jnp.ndarray, chain_id: jnp.ndarray) -> jnp.ndarray:
    """Liberty count per chain representative -> int32[362].

    Each empty point contributes one liberty to each *distinct* adjacent
    chain; distinctness among the <=4 neighbors is resolved with pairwise
    compares. The histogram is a factorized one-hot matmul rather than a
    scatter-add, so it is one dense contraction per board.
    (Replaces GroupTracker's incremental liberty sets, cc/game/board.h:157.)
    """
    empty = stones == EMPTY  # [361]
    nbr_chain = _pad(chain_id, -1)[NEIGHBORS]  # [361, 4]
    c0, c1, c2, c3 = nbr_chain[:, 0], nbr_chain[:, 1], nbr_chain[:, 2], nbr_chain[:, 3]
    m0 = empty & (c0 >= 0)
    m1 = empty & (c1 >= 0) & (c1 != c0)
    m2 = empty & (c2 >= 0) & (c2 != c0) & (c2 != c1)
    m3 = empty & (c3 >= 0) & (c3 != c0) & (c3 != c1) & (c3 != c2)
    masks = jnp.stack([m0, m1, m2, m3], axis=1)  # [361, 4]
    ids = jnp.where(masks, nbr_chain, _SENTINEL).reshape(-1)  # [1444]
    # Two-level factorized one-hot (20 x 19 grid covers ids 0..379 incl. the
    # sentinel 361): materializes [1444, 20] + [1444, 19] instead of
    # [1444, 362], a ~19x memory-traffic saving under vmap.
    hi = ids // BOARD_LEN  # 0..19
    lo = ids % BOARD_LEN
    w = masks.reshape(-1).astype(jnp.bfloat16)
    oh_hi = jax.nn.one_hot(hi, BOARD_LEN + 1, dtype=jnp.bfloat16)
    oh_lo = jax.nn.one_hot(lo, BOARD_LEN, dtype=jnp.bfloat16)
    grid = jnp.einsum("ih,il->hl", oh_hi * w[:, None], oh_lo,
                      preferred_element_type=jnp.float32)
    return grid.reshape(-1)[:NUM_LOCS + 1].astype(jnp.int32)


def point_liberties(stones: jnp.ndarray, chain_id: jnp.ndarray) -> jnp.ndarray:
    """Per-point liberty count of the point's chain -> int32[361] (0 empty)."""
    counts = chain_lib_counts(stones, chain_id)
    gathered = counts[jnp.clip(chain_id, 0, _SENTINEL)]
    return jnp.where(stones != EMPTY, gathered, 0)


def point_liberties_batch(stones: jnp.ndarray,
                          chain_id: jnp.ndarray) -> jnp.ndarray:
    """[B, 361] stones + chain ids -> [B, 361] int32 per-point liberty
    counts. The one liberty pass of the hot path: every descent level's
    legality mask and every leaf's features."""
    return jax.vmap(point_liberties)(stones, chain_id)


def compute_chains(stones: jnp.ndarray) -> jnp.ndarray:
    """Chain ids (min-point-index rep) from raw stones via label propagation.

    Only used for board construction (tests / DSL / handicap setup); the
    per-move path maintains `chain_id` incrementally.
    """
    lbl0 = jnp.where(stones != EMPTY, _IOTA, jnp.int32(-1))
    stones_p = _pad(stones, jnp.int8(99))

    def body(lbl):
        nl = _pad(lbl, jnp.int32(NUM_LOCS))[NEIGHBORS]  # [361, 4]
        same = (stones_p[NEIGHBORS] == stones[:, None]) & (stones != EMPTY)[:, None]
        nl = jnp.where(same, nl, NUM_LOCS)
        cand = jnp.min(nl, axis=1)
        return jnp.where((stones != EMPTY) & (cand < lbl), cand, lbl)

    def cond(carry):
        lbl, prev_changed = carry
        return prev_changed

    def loop_body(carry):
        lbl, _ = carry
        new = body(lbl)
        return new, jnp.any(new != lbl)

    lbl, _ = jax.lax.while_loop(cond, loop_body, (lbl0, jnp.bool_(True)))
    return lbl


def new_state(komi: float = DEFAULT_KOMI) -> GoState:
    stones = jnp.zeros((NUM_LOCS,), jnp.int8)
    h = compute_hash(stones)
    history = jnp.zeros((MAX_HISTORY, 2), jnp.uint32)
    history = history.at[0].set(h)
    return GoState(
        stones=stones,
        chain_id=jnp.full((NUM_LOCS,), -1, jnp.int32),
        hash=h,
        history=history,
        history_len=jnp.int32(1),
        last_moves=jnp.full((NUM_LAST_MOVES,), NOOP_MOVE, jnp.int32),
        to_move=jnp.int8(BLACK),
        ko_point=jnp.int32(-1),
        consecutive_passes=jnp.int32(0),
        passes=jnp.int32(0),
        move_count=jnp.int32(0),
        komi=jnp.asarray(komi, jnp.float32),
        num_b_prisoners=jnp.int32(0),
        num_w_prisoners=jnp.int32(0),
        pass_alive=jnp.zeros((NUM_LOCS,), jnp.int8),
        pa_move=jnp.int32(0),
    )


def from_stones(stones: jnp.ndarray, komi: float = DEFAULT_KOMI,
                to_move: int = BLACK) -> GoState:
    """Build a state from a raw stone array (position-only; empty history)."""
    stones = stones.astype(jnp.int8)
    st = new_state(komi)
    h = compute_hash(stones)
    history = jnp.zeros((MAX_HISTORY, 2), jnp.uint32).at[0].set(h)
    return st._replace(
        stones=stones,
        chain_id=compute_chains(stones),
        hash=h,
        history=history,
        history_len=jnp.int32(1),
        to_move=jnp.int8(to_move),
    )


class _PlaySim(NamedTuple):
    stones: jnp.ndarray  # int8[361] after placement + captures
    chain_id: jnp.ndarray  # int32[361]
    new_rep: jnp.ndarray  # int32 rep of the played stone's chain
    captured_mask: jnp.ndarray  # bool[361]
    num_captured: jnp.ndarray  # int32
    own_libs: jnp.ndarray  # int32 liberties of played chain post-capture
    occupied: jnp.ndarray  # bool — target point was not empty
    suicide: jnp.ndarray  # bool
    new_hash: jnp.ndarray  # uint32[2]


def _simulate_play(stones: jnp.ndarray, chain_id: jnp.ndarray, base_hash: jnp.ndarray,
                   p: jnp.ndarray, c: jnp.ndarray) -> _PlaySim:
    """Resolve stone placement at p for color c: merge, captures, suicide.

    Pure dry-run core shared by step() and the exact legality mask
    (PlayMoveDry semantics, board.cc:595-644).
    """
    c = c.astype(jnp.int8)
    occupied = stones[p] != EMPTY
    stones1 = stones.at[p].set(c)

    nbrs = NEIGHBORS[p]  # [4]
    nbr_color = _pad(stones, jnp.int8(99))[nbrs]
    nbr_chain = _pad(chain_id, jnp.int32(-1))[nbrs]

    friendly = nbr_color == c
    fr = jnp.where(friendly, nbr_chain, NUM_LOCS)
    new_rep = jnp.minimum(p, jnp.min(fr)).astype(jnp.int32)
    chain1 = chain_id.at[p].set(p)
    merge = (
        (chain1 == fr[0]) | (chain1 == fr[1]) | (chain1 == fr[2]) | (chain1 == fr[3])
        | (_IOTA == p)
    )
    chain1 = jnp.where(merge, new_rep, chain1)

    # Only the <=4 opponent neighbor chains (captures) and the merged own
    # chain (suicide) can change liberty status; count just those via a
    # dilate-and-popcount instead of the full per-chain histogram (the
    # histogram's one-hot contraction is the hot path's bandwidth cost).
    def _libs_of(chain_arr, empty_mask, rep):
        m = chain_arr == rep
        dil = jnp.any(_pad(m, jnp.bool_(False))[NEIGHBORS], axis=1)
        return jnp.sum((empty_mask & dil).astype(jnp.int32))

    empty1 = stones1 == EMPTY
    oppm = nbr_color == (-c)
    opp_rep = jnp.where(oppm, nbr_chain, -1)
    cap = oppm & (opp_rep >= 0)
    cap = cap & jnp.stack(
        [_libs_of(chain1, empty1, opp_rep[d]) == 0 for d in range(4)])
    captured_mask = (
        ((chain1 == opp_rep[0]) & cap[0])
        | ((chain1 == opp_rep[1]) & cap[1])
        | ((chain1 == opp_rep[2]) & cap[2])
        | ((chain1 == opp_rep[3]) & cap[3])
    )
    num_captured = jnp.sum(captured_mask.astype(jnp.int32))
    stones2 = jnp.where(captured_mask, jnp.int8(EMPTY), stones1)
    chain2 = jnp.where(captured_mask, jnp.int32(-1), chain1)

    own_libs = _libs_of(chain2, stones2 == EMPTY, new_rep)
    suicide = (own_libs == 0) & ~occupied

    # Incremental additive hash: +z[p,c] -z[p,empty]; captured q: +z[q,empty]
    # -z[q,opp].
    zp = ZOBRIST[p]  # [3, 2]
    c_idx = (c.astype(jnp.int32) + 1)
    opp_idx = (-c.astype(jnp.int32) + 1)
    delta = jnp.take(zp, c_idx, axis=0) - zp[1]
    z_all = ZOBRIST[:NUM_LOCS]  # [361, 3, 2]
    cap_delta = jnp.sum(
        jnp.where(
            captured_mask[:, None],
            z_all[:, 1, :] - jnp.take(z_all, opp_idx, axis=1),
            jnp.zeros((NUM_LOCS, 2), ZOBRIST.dtype),
        ).astype(jnp.uint32),
        axis=0,
        dtype=jnp.uint32,
    )
    new_hash = (base_hash + delta.astype(jnp.uint32) + cap_delta).astype(jnp.uint32)

    return _PlaySim(stones2, chain2, new_rep, captured_mask, num_captured,
                    own_libs, occupied, suicide, new_hash)


def _in_history(state: GoState, h: jnp.ndarray) -> jnp.ndarray:
    """Exact positional-superko membership of uint32[2] hash h.

    A zero-capacity history (search scratch states, see strip_history)
    statically disables the check.
    """
    cap = state.history.shape[0]
    if cap == 0:
        return jnp.bool_(False)
    valid = jnp.arange(cap) < state.history_len
    eq = jnp.all(state.history == h[None, :], axis=1) & valid
    return jnp.any(eq)


def strip_history(state: GoState) -> GoState:
    """Zero-capacity-history view for in-tree search scratch boards.

    The tree search never checks positional superko on simulated moves
    (the cheap mask + real-move guard handle it), so carrying and updating
    the [MAX_HISTORY, 2] ring through every descent step is pure memory
    traffic; this statically removes it.
    """
    return state._replace(history=jnp.zeros((0, 2), jnp.uint32))


def step(state: GoState, action: jnp.ndarray) -> Tuple[GoState, jnp.ndarray]:
    """Play `action` (0..360 point, 361 pass) for state.to_move.

    Returns (new_state, status). An illegal action (occupied / suicide /
    positional superko) leaves the board unchanged and is recorded as a pass
    so lockstep batches always advance; callers that mask legality up front
    (search, selfplay) never hit this path. Reference semantics:
    Board::PlayMove board.cc:536-595.
    """
    action = action.astype(jnp.int32)
    c = state.to_move
    in_bounds = (action >= 0) & (action < NUM_LOCS)
    p = jnp.clip(action, 0, NUM_LOCS - 1)
    is_pass = ~in_bounds

    sim = _simulate_play(state.stones, state.chain_id, state.hash, p, c)
    superko = _in_history(state, sim.new_hash)
    pa_banned = state.pass_alive[p] != EMPTY  # board.cc:607-608
    illegal = (sim.occupied | sim.suicide | superko | pa_banned) & ~is_pass
    do_play = ~is_pass & ~illegal

    status = jnp.where(
        is_pass,
        MOVE_VALID,
        jnp.where(
            sim.occupied,
            MOVE_LOC_NOT_EMPTY,
            jnp.where(
                pa_banned,
                MOVE_PASS_ALIVE_REGION,
                jnp.where(sim.suicide, MOVE_SELF_CAPTURE,
                          jnp.where(superko, MOVE_REPEATED_POSITION,
                                    MOVE_VALID)))),
    ).astype(jnp.int32)

    stones_f = jnp.where(do_play, sim.stones, state.stones)
    chain_f = jnp.where(do_play, sim.chain_id, state.chain_id)
    hash_f = jnp.where(do_play, sim.new_hash, state.hash)
    hist_cap = state.history.shape[0]
    if hist_cap > 0:
        hist_idx = jnp.clip(state.history_len, 0, hist_cap - 1)
        history_f = jnp.where(
            do_play,
            state.history.at[hist_idx].set(sim.new_hash),
            state.history,
        )
    else:
        history_f = state.history
    history_len_f = state.history_len + do_play.astype(jnp.int32)

    # Simple-ko point: exactly one stone captured by a new single-stone chain
    # that itself has exactly one liberty.
    own_size = jnp.sum((sim.chain_id == sim.new_rep).astype(jnp.int32))
    captured_idx = jnp.argmax(sim.captured_mask).astype(jnp.int32)
    new_ko = jnp.where(
        do_play & (sim.num_captured == 1) & (own_size == 1) & (sim.own_libs == 1),
        captured_idx,
        jnp.int32(-1),
    )

    effective_pass = is_pass | illegal
    move_rec = jnp.where(do_play, p, jnp.int32(PASS_MOVE))
    last_moves_f = jnp.concatenate(
        [state.last_moves[1:], move_rec[None]])

    cap_b = jnp.where(c == WHITE, sim.num_captured, 0)
    cap_w = jnp.where(c == BLACK, sim.num_captured, 0)

    new_st = GoState(
        stones=stones_f,
        chain_id=chain_f,
        hash=hash_f,
        history=history_f,
        history_len=history_len_f,
        last_moves=last_moves_f,
        to_move=(-c).astype(jnp.int8),
        ko_point=new_ko,
        consecutive_passes=jnp.where(effective_pass,
                                     state.consecutive_passes + 1, 0),
        passes=state.passes + effective_pass.astype(jnp.int32),
        move_count=state.move_count + 1,
        komi=state.komi,
        num_b_prisoners=state.num_b_prisoners + do_play * cap_b,
        num_w_prisoners=state.num_w_prisoners + do_play * cap_w,
        pass_alive=state.pass_alive,
        pa_move=state.pa_move,
    )
    return new_st, status


def is_game_over(state: GoState) -> jnp.ndarray:
    """Two consecutive passes end the game (board.cc:524)."""
    return state.consecutive_passes >= 2


def legal_mask_from_libs(state: GoState, libs_pt: jnp.ndarray) -> jnp.ndarray:
    """legal_mask with precomputed per-point chain liberty counts."""
    c = state.to_move
    nbr_color = _pad(state.stones, jnp.int8(99))[NEIGHBORS]  # [361, 4]
    nbr_libs = _pad(libs_pt, jnp.int32(0))[NEIGHBORS]
    empty = state.stones == EMPTY
    any_empty_nbr = jnp.any(nbr_color == EMPTY, axis=1)
    safe_friend = jnp.any((nbr_color == c) & (nbr_libs >= 2), axis=1)
    captures = jnp.any((nbr_color == (-c)) & (nbr_libs == 1), axis=1)
    legal = empty & (any_empty_nbr | safe_friend | captures)
    legal = legal & (_IOTA != state.ko_point)
    # Moves inside Benson pass-alive regions are banned for both colors
    # (board.cc:607-608 kPassAliveRegion); pass stays legal.
    legal = legal & (state.pass_alive == EMPTY)
    return jnp.concatenate([legal, jnp.ones((1,), jnp.bool_)])


def legal_mask(state: GoState) -> jnp.ndarray:
    """Cheap legality mask for state.to_move -> bool[362].

    Exact for everything except positional superko beyond the simple ko
    (which `step` / `superko_violation` enforce on the played move). The
    search tree uses this mask; the reference instead dry-runs every
    candidate (gumbel.cc:287-306 -> PlayMoveDry), which full_legal_mask
    mirrors for parity tests.
    """
    return legal_mask_from_libs(
        state, point_liberties(state.stones, state.chain_id))


def legal_mask_batch(states: GoState) -> jnp.ndarray:
    """Batched legality mask [B, 362] from one batched liberty pass."""
    libs = point_liberties_batch(states.stones, states.chain_id)
    return jax.vmap(legal_mask_from_libs)(states, libs)


def dry_run_status(state: GoState, action: jnp.ndarray) -> jnp.ndarray:
    """Exact move status for one action, incl. positional superko."""
    action = action.astype(jnp.int32)
    in_bounds = (action >= 0) & (action < NUM_LOCS)
    p = jnp.clip(action, 0, NUM_LOCS - 1)
    sim = _simulate_play(state.stones, state.chain_id, state.hash, p,
                         state.to_move)
    superko = _in_history(state, sim.new_hash)
    pa_banned = state.pass_alive[p] != EMPTY
    return jnp.where(
        ~in_bounds,
        MOVE_VALID,  # pass
        jnp.where(
            sim.occupied,
            MOVE_LOC_NOT_EMPTY,
            jnp.where(
                pa_banned,
                MOVE_PASS_ALIVE_REGION,
                jnp.where(sim.suicide, MOVE_SELF_CAPTURE,
                          jnp.where(superko, MOVE_REPEATED_POSITION,
                                    MOVE_VALID)))),
    ).astype(jnp.int32)


def full_legal_mask(state: GoState) -> jnp.ndarray:
    """Exact legality (incl. positional superko) for all 362 actions.

    ~361x the cost of `legal_mask`; for tests, GTP and analysis.
    """
    statuses = jax.vmap(lambda a: dry_run_status(state, a))(
        jnp.arange(NUM_MOVES, dtype=jnp.int32))
    return statuses == MOVE_VALID


def superko_violation(state: GoState, action: jnp.ndarray) -> jnp.ndarray:
    """Would playing `action` repeat a previous position? (single action)"""
    action = action.astype(jnp.int32)
    in_bounds = (action >= 0) & (action < NUM_LOCS)
    p = jnp.clip(action, 0, NUM_LOCS - 1)
    sim = _simulate_play(state.stones, state.chain_id, state.hash, p,
                         state.to_move)
    return in_bounds & ~sim.occupied & ~sim.suicide & _in_history(state, sim.new_hash)
