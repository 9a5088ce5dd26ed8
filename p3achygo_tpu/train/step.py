"""Jitted training step (mirrors python/train.py train_step :50 semantics:
forward, compute_losses, grads, apply; bf16 compute keeps f32's exponent
range, so it needs no loss scaling — fp32 master params, no
LossScaleOptimizer)."""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from p3achygo_tpu.models.losses import GroundTruth, LossCoeffs, compute_losses


class TrainState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray


def create_train_state(variables, tx: optax.GradientTransformation) -> TrainState:
    return TrainState(
        params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros([], jnp.int32),
    )


def make_train_step(model, tx: optax.GradientTransformation,
                    coeffs: LossCoeffs
                    ) -> Callable[[TrainState, jnp.ndarray, jnp.ndarray,
                                   GroundTruth],
                                  Tuple[TrainState, Dict[str, jnp.ndarray]]]:
    def train_step(state: TrainState, planes, scalars, targets):
        def loss_fn(params):
            outputs, mutated = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                planes, scalars, train=True, mutable=["batch_stats"])
            losses = compute_losses(outputs, targets, coeffs)
            return losses["loss"], (losses, mutated["batch_stats"])

        (loss, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        gnorm = optax.global_norm(grads)
        losses = dict(losses)
        losses["grad_norm"] = gnorm
        return TrainState(
            params=new_params,
            batch_stats=new_bs,
            opt_state=new_opt_state,
            step=state.step + 1,
        ), losses

    return train_step
