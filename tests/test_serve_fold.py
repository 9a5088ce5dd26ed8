"""Serve-graph (BN fold + head pruning) parity vs `model.apply`.

p3achygo_tpu/nn/serve.py must reproduce the model's search-consumed
outputs with the same weights: f32 near-exact (fold is pure algebra),
bf16 within rounding + top-1 policy agreement. Mirrors the reference's
engine parity checks (cc/nn/engine/compare_engines.cc)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p3achygo_tpu.models import build_model, get_config, init_params
from p3achygo_tpu.models.config import ModelConfig
from p3achygo_tpu.nn.serve import serve_forward, serve_supported


def _randomized_stats(variables, seed):
    """BN running stats straight from init are (0, 1) — randomize them so
    folding bugs can't hide."""
    k = [jax.random.PRNGKey(seed)]

    def rnd(x):
        k[0], sub = jax.random.split(k[0])
        return x + jax.random.uniform(sub, x.shape, jnp.float32, 0.01, 0.4)

    stats = jax.tree_util.tree_map(rnd, variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def _randomized_params(variables, seed):
    """Init gives zero-centered conv kernels but zero biases for some
    heads (gamma_output is zeros-init): perturb params too so every
    folded term is nonzero."""
    k = [jax.random.PRNGKey(seed)]

    def rnd(x):
        k[0], sub = jax.random.split(k[0])
        return x + 0.05 * jax.random.normal(sub, x.shape, jnp.float32)

    params = jax.tree_util.tree_map(rnd, variables["params"])
    return {**variables, "params": params}


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    planes = jnp.asarray(rng.normal(size=(n, 19, 19, 15)) > 1.0, jnp.float32)
    scalars = jnp.asarray(rng.normal(size=(n, 8)) * 0.3, jnp.float32)
    return planes, scalars


_NBT_SMALL = ModelConfig(blocks=4, broadcast_interval=3, channels=16,
                         bottleneck_channels=8, head_channels=8, c_val=16,
                         trunk_block_type="nbt")
_CLASSIC_SMALL = ModelConfig(blocks=4, broadcast_interval=3, channels=16,
                             head_channels=8, c_val=16,
                             trunk_block_type="classic")


def _cfg(name):
    return {"b8c64": get_config("b8c64"), "tiny": get_config("tiny"),
            "nbt": _NBT_SMALL, "classic": _CLASSIC_SMALL}[name]


@pytest.mark.parametrize("config_name", ["tiny", "b8c64", "nbt", "classic"])
def test_serve_fold_f32_tight(config_name):
    cfg = _cfg(config_name)
    assert serve_supported(cfg)
    model = build_model(cfg, dtype=jnp.float32)
    variables = _randomized_params(
        _randomized_stats(init_params(model, jax.random.PRNGKey(0)), seed=7),
        seed=11)
    planes, scalars = _inputs(4, seed=3)

    ref = model.apply(variables, planes, scalars, train=False)
    got = serve_forward(model, variables, planes, scalars,
                        want_optimistic=True)

    np.testing.assert_allclose(np.asarray(got.pi_logits),
                               np.asarray(ref.pi_logits),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.pi_logits_optimistic),
                               np.asarray(ref.pi_logits_optimistic),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got.outcome_probs),
                               np.asarray(ref.outcome_probs), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.score_probs),
                               np.asarray(ref.score_probs), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.q6_err),
                               np.asarray(ref.q6_err), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.gamma),
                               np.asarray(ref.gamma), atol=1e-5)


@pytest.mark.parametrize("config_name", ["b8c64"])
def test_serve_fold_bf16(config_name):
    cfg = _cfg(config_name)
    model = build_model(cfg, dtype=jnp.bfloat16)
    variables = _randomized_params(
        _randomized_stats(init_params(model, jax.random.PRNGKey(1)), seed=9),
        seed=13)
    planes, scalars = _inputs(16, seed=5)

    ref = model.apply(variables, planes, scalars, train=False)
    got = serve_forward(model, variables, planes, scalars)

    np.testing.assert_allclose(np.asarray(got.pi_logits),
                               np.asarray(ref.pi_logits),
                               atol=0.15, rtol=0.05)
    np.testing.assert_allclose(np.asarray(got.outcome_probs),
                               np.asarray(ref.outcome_probs), atol=0.03)
    np.testing.assert_allclose(np.asarray(got.score_probs),
                               np.asarray(ref.score_probs), atol=0.02)
    assert (np.argmax(np.asarray(got.pi_logits), -1)
            == np.argmax(np.asarray(ref.pi_logits), -1)).all()


def test_serve_fold_through_eval_fn():
    """make_eval_fn(serve_fold=True) matches the model.apply eval path on every
    EvalOutput field (bf16 tolerances) and stays jit-able."""
    from p3achygo_tpu.game.board import new_state
    from p3achygo_tpu.mcts.gumbel import make_eval_fn

    cfg = get_config("tiny")
    model = build_model(cfg, dtype=jnp.bfloat16)
    variables = _randomized_params(
        _randomized_stats(init_params(model, jax.random.PRNGKey(2)), seed=4),
        seed=6)

    states = jax.vmap(lambda _: new_state(7.5))(jnp.arange(8))
    ref_fn = jax.jit(make_eval_fn(model, variables))
    got_fn = jax.jit(make_eval_fn(model, variables, serve_fold=True))
    ref, got = ref_fn(states), got_fn(states)

    np.testing.assert_allclose(np.asarray(got.log_priors),
                               np.asarray(ref.log_priors),
                               atol=0.15, rtol=0.05)
    np.testing.assert_allclose(np.asarray(got.outcome_value),
                               np.asarray(ref.outcome_value), atol=0.05)
    np.testing.assert_allclose(np.asarray(got.score_est),
                               np.asarray(ref.score_est), atol=1.0)
    np.testing.assert_allclose(np.asarray(got.err_est),
                               np.asarray(ref.err_est), atol=0.05)
