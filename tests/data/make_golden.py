"""Write the model fixtures that tests/test_model.py checks against:

- model_golden_tiny.npz: the `tiny` config's variables from PRNGKey(0),
  fixed inputs, the eval-mode outputs, and the train-mode outputs with the
  updated batch statistics, all in f32 at "highest" precision on the CPU;
- param_tree_manifest.json: path -> [shape, dtype] of every config's
  variables.

The committed fixtures were written by this script at commit 6e8613a, whose
models were flax modules, so the tests hold the plain-JAX models to that
graph; run there, it reproduces them bit for bit. Run on a later tree, it
writes that tree's outputs instead, from other initial values (the
plain-JAX init draws its random numbers differently):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/make_golden.py [--out DIR]
"""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from p3achygo_tpu.constants import (
    BOARD_LEN,
    NUM_INPUT_FEATURES,
    NUM_INPUT_PLANES,
)
from p3achygo_tpu.models import build_model, get_config, init_params
from p3achygo_tpu.models.config import CONFIG_OPTIONS


def flat(tree, prefix):
    return {prefix + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.dirname(os.path.abspath(
        __file__)))
    out_dir = ap.parse_args().out

    model = build_model(get_config("tiny"), dtype=jnp.float32)
    variables = init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    planes = (rng.random((4, BOARD_LEN, BOARD_LEN, NUM_INPUT_PLANES))
              < 0.3).astype(np.float32)
    scalars = rng.standard_normal((4, NUM_INPUT_FEATURES)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ev = model.apply(variables, planes, scalars, train=False)
        tr, mut = model.apply(variables, planes, scalars, train=True,
                              mutable=["batch_stats"])
    arrays = {"input/planes": planes, "input/scalars": scalars}
    arrays.update(flat(variables, "variables/"))
    arrays.update({f"eval/{k}": np.asarray(v)
                   for k, v in ev._asdict().items()})
    arrays.update({f"train/{k}": np.asarray(v)
                   for k, v in tr._asdict().items()})
    arrays.update(flat(mut["batch_stats"], "train_batch_stats/"))
    np.savez_compressed(os.path.join(out_dir, "model_golden_tiny.npz"),
                        **arrays)

    manifest = {}
    for name in CONFIG_OPTIONS:
        m = build_model(get_config(name), dtype=jnp.float32)
        shapes = jax.eval_shape(lambda k: init_params(m, k),
                                jax.random.PRNGKey(0))
        manifest[name] = {
            "/".join(k.key for k in path): [list(leaf.shape), str(leaf.dtype)]
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with open(os.path.join(out_dir, "param_tree_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(len(arrays), {k: len(v) for k, v in manifest.items()})


if __name__ == "__main__":
    main()
