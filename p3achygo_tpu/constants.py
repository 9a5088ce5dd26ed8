"""Framework-wide constants.

Mirrors the reference's cc/constants/constants.h:7-84 and
python/constants.py, re-expressed for the array-program engine.
"""
from __future__ import annotations

BOARD_LEN = 19
NUM_LOCS = BOARD_LEN * BOARD_LEN  # 361
NUM_MOVES = NUM_LOCS + 1  # 362, incl. pass
PASS_MOVE = NUM_LOCS  # 361
NOOP_MOVE = -1

# Stone / color encoding (matches reference cc/game/color.h).
EMPTY = 0
BLACK = 1
WHITE = -1

MAX_GAME_LEN = 600

NUM_LAST_MOVES = 5

NUM_INPUT_PLANES = 15  # v1 featurization
NUM_INPUT_FEATURES = 8  # v1 scalar features

NUM_VALUE_LOGITS = 2
NUM_SCORE_LOGITS = 800
SCORE_INFLECTION_POINT = 400

NUM_V_BUCKETS = 51  # categorical value histogram buckets

NUM_PASSES_BEFORE_BENSONS = 3

GO_EXPLOIT_BUFFER_SIZE = 8192

# Superko history ring capacity (positions seen this game, incl. the empty
# start position). Reference keeps an unbounded absl::flat_hash_set
# (cc/game/board.h seen_states_); games are capped at MAX_GAME_LEN so a
# fixed ring is exact.
MAX_HISTORY = MAX_GAME_LEN + 16

DEFAULT_KOMI = 7.5
