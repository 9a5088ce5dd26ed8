"""Bounded vectorized ladder reading for the laddered-stones feature planes.

The reference reads ladders with a recursive forking solver capped at depth
300 (cc/game/board.cc:692-899 GetLadderedStones). Recursion and forking
don't map to lockstep execution, so this is a *bounded greedy chase*:

- Candidate chains: up to `MAX_CANDIDATES` chains with 1 or 2 liberties.
- Chase loop (static `MAX_DEPTH` iterations, masked when resolved):
  - defender at 1 liberty extends at it; if the extension still leaves
    <= 1 liberty the chain is laddered;
  - at 2 liberties the attacker greedily plays whichever liberty leaves the
    defender fewer liberties (1-ply lookahead over both, no forking);
  - >= 3 liberties = escaped.

This captures the classic diagonal ladder and simple nets; it can disagree
with the reference on positions where only one of the two attacker branches
works deeper in. It feeds feature planes only, so the deviation trades a
little plane accuracy for a fully batched, fixed-shape program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import EMPTY, NUM_LOCS
from p3achygo_tpu.game.board import (
    GoState,
    NEIGHBORS,
    _pad,
    _simulate_play,
    chain_lib_counts,
)

MAX_CANDIDATES = 8
# A full-board zigzag ladder costs ~2 plies per diagonal step (~37 steps
# corner to corner) plus the capture tail; the loop exits early once
# resolved, so the cap only binds on pathological boards (reference solver
# depth: 300, board.cc:696).
MAX_DEPTH = 96

_IOTA = jnp.arange(NUM_LOCS, dtype=jnp.int32)
_DUMMY_HASH = jnp.zeros((2,), jnp.uint32)


def _chain_liberty_points(stones, chain_id, rep):
    """bool[361]: empty points that are liberties of chain `rep`."""
    adj = _pad(chain_id, jnp.int32(-1))[NEIGHBORS]  # [361, 4]
    is_lib = (stones == EMPTY) & jnp.any(adj == rep, axis=1) & (rep >= 0)
    return is_lib


def _first_two(mask):
    """Indices of the first two set bits of bool[361] (or -1)."""
    idx = jnp.where(mask, _IOTA, NUM_LOCS)
    first = jnp.min(idx)
    idx2 = jnp.where(mask & (_IOTA != first), _IOTA, NUM_LOCS)
    second = jnp.min(idx2)
    to_valid = lambda v: jnp.where(v < NUM_LOCS, v, -1).astype(jnp.int32)
    return to_valid(first), to_valid(second)


def _chase_one(stones, chain_id, rep, color):
    """Greedy ladder chase of chain `rep` (defender color `color`).

    Returns bool: chain is captured in the ladder.
    """

    def defender_libs(st, cid, r):
        return jnp.where(r >= 0, chain_lib_counts(st, cid)[jnp.clip(r, 0, NUM_LOCS)], 99)

    def body(carry):
        st, cid, r, to_move_is_defender, done, laddered, depth = carry
        libs = defender_libs(st, cid, r)

        # Counter-atari (the reference's recursive solver reads this
        # line): if an ATTACKER chain adjacent to the laddered chain is in
        # atari, the defender captures it instead of extending and the
        # chase continues on the new board. Snapback refutations are not
        # re-read (documented approximation).
        chain_mask = (cid == r) & (r >= 0)
        nbr_in_chain = jnp.any(
            _pad(chain_mask, jnp.bool_(False))[NEIGHBORS], axis=1)
        counts_all = chain_lib_counts(st, cid)
        opp_atari_adj = ((st == (-color).astype(st.dtype)) & nbr_in_chain
                         & (counts_all[jnp.clip(cid, 0, NUM_LOCS)] == 1))
        counter_atari = jnp.any(opp_atari_adj)
        cap_cell = jnp.argmax(opp_atari_adj).astype(jnp.int32)
        cap_rep = cid[jnp.clip(cap_cell, 0, NUM_LOCS - 1)]
        cap_pt, _ = _first_two(_chain_liberty_points(st, cid, cap_rep))

        # Resolution checks.
        captured = libs == 0
        escaped = libs >= 3
        newly_done = captured | escaped
        laddered = laddered | (captured & ~done)
        done = done | newly_done

        lib1, lib2 = _first_two(_chain_liberty_points(st, cid, r))

        def defender_move(st, cid, r):
            # Capture an adjacent attacker chain in atari if possible,
            # else extend at the single liberty.
            sim_cap = _simulate_play(st, cid, _DUMMY_HASH,
                                     jnp.clip(cap_pt, 0, NUM_LOCS - 1), color)
            cap_ok = counter_atari & (cap_pt >= 0) & ~sim_cap.suicide \
                & ~sim_cap.occupied
            sim_ext = _simulate_play(st, cid, _DUMMY_HASH,
                                     jnp.clip(lib1, 0, NUM_LOCS - 1), color)
            ext_ok = (lib1 >= 0) & ~sim_ext.suicide
            pick = lambda a, b: jax.tree_util.tree_map(
                lambda x, y: jnp.where(cap_ok, x, y), a, b)
            sim = pick(sim_cap, sim_ext)
            # The rep CELL stays inside the (possibly merged) chain, so the
            # new rep is its chain id on the new board.
            new_r = sim.chain_id[jnp.clip(r, 0, NUM_LOCS - 1)]
            return sim.stones, sim.chain_id, new_r, cap_ok | ext_ok

        def attacker_move(st, cid, r):
            att = (-color).astype(jnp.int8)

            def try_at(lib):
                # 2-ply lookahead: attacker plays `lib`, defender makes its
                # forced extension; rank by the defender's liberties after
                # both plies (the classic ladder choice is invisible at
                # 1 ply — both ataris look identical).
                p = jnp.clip(lib, 0, NUM_LOCS - 1)
                sim = _simulate_play(st, cid, _DUMMY_HASH, p, att)
                libs_after = defender_libs(sim.stones, sim.chain_id, r)
                ok = (lib >= 0) & ~sim.suicide & ~sim.occupied
                dlib, _ = _first_two(
                    _chain_liberty_points(sim.stones, sim.chain_id, r))
                dsim = _simulate_play(sim.stones, sim.chain_id, _DUMMY_HASH,
                                      jnp.clip(dlib, 0, NUM_LOCS - 1), color)
                d_rep = dsim.chain_id[jnp.clip(dlib, 0, NUM_LOCS - 1)]
                libs2 = jnp.where(
                    (dlib >= 0) & ~dsim.suicide,
                    defender_libs(dsim.stones, dsim.chain_id, d_rep),
                    0)  # defender cannot even extend: captured next ply
                # Non-forcing attacker moves (defender keeps >= 2 libs) rank
                # last; among forcing moves, minimize post-extension libs.
                sc = jnp.where(libs_after >= 2, 1000 + libs_after, libs2)
                return sim, jnp.where(ok, sc, 9999), ok

            sim1, s1, ok1 = try_at(lib1)
            sim2, s2, ok2 = try_at(lib2)
            use1 = s1 <= s2
            pick = lambda a, b: jax.tree_util.tree_map(
                lambda x, y: jnp.where(use1, x, y), a, b)
            sim = pick(sim1, sim2)
            ok = jnp.where(use1, ok1, ok2)
            return sim.stones, sim.chain_id, r, ok

        at_def = to_move_is_defender & (libs == 1)
        at_att = ~to_move_is_defender & (libs == 2)
        # Situations the chase doesn't cover resolve as escape:
        # defender to move with 2 libs (not forced), attacker with 1-lib
        # target (just captures -> laddered).
        attacker_captures = ~to_move_is_defender & (libs == 1)
        laddered = laddered | (attacker_captures & ~done)
        done = done | attacker_captures | (to_move_is_defender & (libs == 2))

        d_st, d_cid, d_r, d_ok = defender_move(st, cid, r)
        a_st, a_cid, a_r, a_ok = attacker_move(st, cid, r)

        # Defender can't extend -> captured; attacker has no working move ->
        # escape.
        laddered = laddered | (at_def & ~d_ok & ~done)
        done = done | (at_def & ~d_ok) | (at_att & ~a_ok)

        take_def = at_def & d_ok & ~done
        take_att = at_att & a_ok & ~done
        st = jnp.where(take_def, d_st, jnp.where(take_att, a_st, st))
        cid = jnp.where(take_def, d_cid, jnp.where(take_att, a_cid, cid))
        r = jnp.where(take_def, d_r, jnp.where(take_att, a_r, r))
        to_move_is_defender = jnp.where(take_def | take_att,
                                        ~to_move_is_defender, to_move_is_defender)
        return st, cid, r, to_move_is_defender, done, laddered, depth + 1

    def cond(carry):
        _, _, _, _, done, _, depth = carry
        return ~done & (depth < MAX_DEPTH)

    libs0 = defender_libs(stones, chain_id, rep)
    # Attacker moves first on 2-lib chains; defender must respond at 1 lib.
    to_move_is_defender0 = libs0 == 1
    init = (stones, chain_id, rep, to_move_is_defender0,
            (rep < 0) | (libs0 >= 3), jnp.bool_(False), jnp.int32(0))
    _, _, _, _, _, laddered, _ = jax.lax.while_loop(cond, body, init)
    return laddered


def laddered_stones(state: GoState) -> jnp.ndarray:
    """bool[361]: stones belonging to chains capturable in a greedy ladder."""
    stones, chain_id = state.stones, state.chain_id
    counts = chain_lib_counts(stones, chain_id)
    is_rep = (chain_id == _IOTA) & (stones != EMPTY)
    cand = is_rep & ((counts[jnp.clip(chain_id, 0, NUM_LOCS)] == 1)
                     | (counts[jnp.clip(chain_id, 0, NUM_LOCS)] == 2))
    # First MAX_CANDIDATES candidate reps in board order.
    order = jnp.where(cand, _IOTA, NUM_LOCS)
    reps = jnp.sort(order)[:MAX_CANDIDATES]
    reps = jnp.where(reps < NUM_LOCS, reps, -1).astype(jnp.int32)
    colors = jnp.where(reps >= 0, stones[jnp.clip(reps, 0, NUM_LOCS - 1)],
                       jnp.int8(0)).astype(jnp.int8)

    laddered = jax.vmap(
        lambda r, c: _chase_one(stones, chain_id, r, c))(reps, colors)
    laddered = laddered & (reps >= 0)

    out = jnp.zeros((NUM_LOCS,), jnp.bool_)
    for k in range(MAX_CANDIDATES):
        out = out | ((chain_id == reps[k]) & laddered[k] & (reps[k] >= 0))
    return out
