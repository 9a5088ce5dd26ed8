"""Checkpoints as .npz of flattened key paths (train/checkpoint.py)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from p3achygo_tpu.models import build_model, get_config, init_params
from p3achygo_tpu.train.checkpoint import (
    LIVE_NAME,
    latest_generation,
    restore_checkpoint,
    save_checkpoint,
    save_named,
)


def _assert_same(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def variables():
    return init_params(build_model(get_config("tiny")), jax.random.PRNGKey(0))


def test_roundtrip_bf16_and_optax_state(tmp_path, variables):
    bf16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                  variables["params"])
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=0.1, momentum=0.9)
    opt_state = tx.init(variables["params"])
    tree = {"params": bf16, "opt_state": opt_state,
            "step": jnp.asarray(7, jnp.int32),
            "key": jax.random.PRNGKey(3), "sel_mult_base": 1.5}
    path = save_named(str(tmp_path), "bundle", tree)
    assert os.path.isdir(path)
    zeros = jax.tree_util.tree_map(
        lambda x: jnp.zeros_like(x) if isinstance(x, jax.Array) else 0.0,
        tree)
    restored = restore_checkpoint(path, zeros)
    _assert_same(restored, tree)
    assert restored["params"]["init_board_conv"]["kernel"].dtype == jnp.bfloat16


def test_live_copy_and_latest_generation(tmp_path, variables):
    root = str(tmp_path)
    assert latest_generation(root) is None
    save_checkpoint(root, 1, variables, live=False)
    path = save_checkpoint(root, 2, variables, live=True)
    assert os.path.basename(path) == "model_0002"
    assert latest_generation(root) == 2
    _assert_same(restore_checkpoint(os.path.join(root, LIVE_NAME), variables),
                 restore_checkpoint(path, variables))
    assert not os.path.exists(os.path.join(root, "model_0001", LIVE_NAME))


def test_restore_rejects_mismatched_template(tmp_path, variables):
    path = save_named(str(tmp_path), "m", variables)
    wrong = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                   variables)
    with pytest.raises(ValueError, match="template wants"):
        restore_checkpoint(path, wrong)
