"""Experiments layer (cc/experiments/, SURVEY §2.9).

Batched ports of the reference's research harnesses:

- visits_study: Gumbel visit-count study (gumbel_visits_study.cc) — KLD
  between a ground-truth improved policy and N-visit searches seeded with
  PUCT visits, over positions loaded from a tfrecord chunk. The per-example
  loop becomes ONE lockstep batch per (search-kind, N) pair.
- play_games: play full games with per-move callbacks (play_games.cc,
  callbacks.h) — PrintCallback and the BiasCallback top-|NN-MCTS| heap.
"""
from p3achygo_tpu.experiments.play_games import (BiasCallback, PrintCallback,
                                                 play_games)
from p3achygo_tpu.experiments.visits_study import (
    run_visits_study, states_from_examples)

__all__ = [
    "BiasCallback",
    "PrintCallback",
    "play_games",
    "run_visits_study",
    "states_from_examples",
]
