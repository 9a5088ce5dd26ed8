"""The batched liberty pass (game.board.point_liberties_batch) against an
independent numpy flood-fill oracle."""
import jax
import numpy as np
import pytest

from p3achygo_tpu.game import (
    board_from_dsl,
    point_liberties_batch,
    random_positions,
)


def flood_fill_liberties(stones: np.ndarray) -> np.ndarray:
    """[361] stones -> [361] liberty count of each stone's chain (0 empty),
    by breadth-first search over the 19x19 grid."""
    grid = stones.reshape(19, 19)
    libs = np.zeros((19, 19), np.int32)
    seen = np.zeros((19, 19), bool)
    for r0 in range(19):
        for c0 in range(19):
            if grid[r0, c0] == 0 or seen[r0, c0]:
                continue
            chain, frontier, empties = [], [(r0, c0)], set()
            seen[r0, c0] = True
            while frontier:
                r, c = frontier.pop()
                chain.append((r, c))
                for rr, cc in ((r + 1, c), (r - 1, c), (r, c + 1), (r, c - 1)):
                    if not (0 <= rr < 19 and 0 <= cc < 19):
                        continue
                    if grid[rr, cc] == 0:
                        empties.add((rr, cc))
                    elif grid[rr, cc] == grid[r, c] and not seen[rr, cc]:
                        seen[rr, cc] = True
                        frontier.append((rr, cc))
            for r, c in chain:
                libs[r, c] = len(empties)
    return libs.reshape(-1)


@pytest.fixture(scope="module")
def positions():
    """Random mid-game playouts, 8 boards per seed (one compiled program)."""
    return {seed: random_positions(jax.random.PRNGKey(seed), 8, 80)
            for seed in (0, 1, 2)}


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_liberties_match_flood_fill(positions, seed, batch):
    states = positions[seed]
    stones = np.asarray(states.stones[:batch])
    got = np.asarray(point_liberties_batch(states.stones[:batch],
                                           states.chain_id[:batch]))
    assert got.shape == (batch, 361) and got.dtype == np.int32
    want = np.stack([flood_fill_liberties(s) for s in stones])
    np.testing.assert_array_equal(got, want)
    assert (stones != 0).sum() > 10 * batch  # real mid-game boards


def test_liberties_on_dsl_position():
    st = board_from_dsl(
        """
        x o . . .
        . o o . .
        x x . . .
        """)
    got = np.asarray(point_liberties_batch(st.stones[None],
                                           st.chain_id[None]))[0]
    np.testing.assert_array_equal(got, flood_fill_liberties(
        np.asarray(st.stones)))
    # white chain (0,1),(1,1),(1,2): libs (0,2),(1,0),(2,2),(1,3) = 4
    assert got[1] == 4


def test_liberties_empty_board_is_zero():
    st = board_from_dsl(". . .")
    got = np.asarray(point_liberties_batch(st.stones[None],
                                           st.chain_id[None]))
    assert not got.any()
