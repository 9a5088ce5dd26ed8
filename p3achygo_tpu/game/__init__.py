"""Vectorized Go rules engine (board, symmetry, scoring, DSL)."""
from p3achygo_tpu.game.board import (  # noqa: F401
    GoState,
    MOVE_LOC_NOT_EMPTY,
    MOVE_REPEATED_POSITION,
    MOVE_SELF_CAPTURE,
    MOVE_VALID,
    chain_lib_counts,
    compute_chains,
    compute_hash,
    dry_run_status,
    from_stones,
    full_legal_mask,
    is_game_over,
    legal_mask,
    new_state,
    legal_mask_batch,
    point_liberties,
    point_liberties_batch,
    step,
    superko_violation,
)
from p3achygo_tpu.game.playout import random_positions  # noqa: F401
from p3achygo_tpu.game.scoring import compute_pass_alive, score  # noqa: F401
from p3achygo_tpu.game.dsl import board_from_dsl, parse_dsl, render  # noqa: F401
