"""p3achygo_tpu: an AlphaZero Go framework written as one JAX array program.

Brand-new JAX/XLA/Pallas re-design of the capabilities of
p3achyjr/p3achygo (see SURVEY.md): vectorized rules engine, batched
Gumbel/PUCT MCTS, on-device model inference, self-play/replay/training/eval
as one sharded actor-learner program.
"""
__version__ = "0.1.0"
