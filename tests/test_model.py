"""Model + loss tests (vs model.py heads/losses semantics)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from p3achygo_tpu.constants import (
    NUM_INPUT_FEATURES,
    NUM_INPUT_PLANES,
    NUM_MOVES,
    NUM_SCORE_LOGITS,
    NUM_V_BUCKETS,
)
from p3achygo_tpu.models import (
    GroundTruth,
    LossCoeffs,
    build_model,
    compute_losses,
    get_config,
    init_params,
)


def _dummy_inputs(rng, n):
    k1, k2 = jax.random.split(rng)
    board = jax.random.uniform(k1, (n, 19, 19, NUM_INPUT_PLANES))
    scalars = jax.random.uniform(k2, (n, NUM_INPUT_FEATURES))
    return board, scalars


def _dummy_targets(rng, n):
    ks = jax.random.split(rng, 6)
    pol = jax.nn.softmax(jax.random.normal(ks[0], (n, NUM_MOVES)))
    score_idx = jax.random.randint(ks[1], (n,), 0, NUM_SCORE_LOGITS)
    return GroundTruth(
        policy=pol,
        policy_aux=jax.random.randint(ks[2], (n,), 0, NUM_MOVES),
        score=jnp.zeros((n,)),
        score_one_hot=jax.nn.one_hot(score_idx, NUM_SCORE_LOGITS),
        game_outcome=jax.nn.one_hot(jax.random.randint(ks[3], (n,), 0, 2), 2),
        own=jax.random.uniform(ks[4], (n, 361), minval=-1, maxval=1),
        q6=jnp.zeros((n,)), q16=jnp.zeros((n,)), q50=jnp.zeros((n,)),
        q6_score=jnp.zeros((n,)), q16_score=jnp.zeros((n,)),
        q50_score=jnp.zeros((n,)),
        policy_aux_dist=pol,
        has_pi_aux_dist=jnp.ones((n,), bool),
        mcts_value_dist=jnp.ones((n, NUM_V_BUCKETS)),
        has_mcts_value_dist=jnp.ones((n,), bool),
    )


@pytest.mark.parametrize("name", ["tiny", "b8c64"])
def test_forward_shapes(name):
    model = build_model(get_config(name))
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 2)
    out = model.apply(variables, board, scalars, train=False)
    assert out.pi_logits.shape == (2, NUM_MOVES)
    assert out.pi_probs.shape == (2, NUM_MOVES)
    assert out.outcome_logits.shape == (2, 2)
    assert out.ownership.shape == (2, 361)
    assert out.score_logits.shape == (2, NUM_SCORE_LOGITS)
    assert out.gamma.shape == (2, 1)
    assert out.q6.shape == (2,)
    assert out.mcts_dist_logits.shape == (2, NUM_V_BUCKETS)
    # all outputs fp32 and finite
    for t in out:
        assert t.dtype == jnp.float32
        assert bool(jnp.all(jnp.isfinite(t)))
    # probs sum to 1
    np.testing.assert_allclose(np.asarray(out.pi_probs.sum(-1)), 1.0, atol=1e-5)
    # q err bounded [0, 4]
    assert bool(jnp.all((out.q6_err >= 0) & (out.q6_err <= 4)))


def test_transformer_forward():
    model = build_model(get_config("b14d96h3_transformer"))
    # shrink for test speed
    cfg = get_config("b14d96h3_transformer")
    import dataclasses
    cfg = dataclasses.replace(cfg, blocks=2)
    model = build_model(cfg)
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 2)
    out = model.apply(variables, board, scalars, train=False)
    assert out.pi_logits.shape == (2, NUM_MOVES)


def test_bf16_compute():
    model = build_model(get_config("tiny"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 2)
    out = model.apply(variables, board, scalars, train=False)
    assert out.pi_logits.dtype == jnp.float32  # heads cast back
    assert bool(jnp.all(jnp.isfinite(out.pi_logits)))


def test_batchnorm_updates():
    model = build_model(get_config("tiny"))
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 4)
    out, mutated = model.apply(variables, board, scalars, train=True,
                               mutable=["batch_stats"])
    assert "batch_stats" in mutated


def test_losses_finite_and_decrease_on_perfect_targets():
    model = build_model(get_config("tiny"))
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 4)
    out = model.apply(variables, board, scalars, train=False)
    targets = _dummy_targets(jax.random.PRNGKey(2), 4)
    losses = compute_losses(out, targets, LossCoeffs.rl())
    for k, v in losses.items():
        assert np.isfinite(float(v)), k
    assert float(losses["loss"]) > 0

    # Self-consistent targets -> policy loss ~ 0.
    perfect = targets._replace(policy=out.pi_probs)
    losses2 = compute_losses(out, perfect, LossCoeffs.rl())
    assert float(losses2["policy"]) < 1e-3


def test_loss_gradients_flow():
    model = build_model(get_config("tiny"))
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 2)
    targets = _dummy_targets(jax.random.PRNGKey(2), 2)

    def loss_fn(params):
        out = model.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          board, scalars, train=False)
        return compute_losses(out, targets, LossCoeffs.rl())["loss"]

    g = jax.grad(loss_fn)(variables["params"])
    leaves = jax.tree_util.tree_leaves(g)
    assert all(bool(jnp.all(jnp.isfinite(l))) for l in leaves)
    total_norm = sum(float(jnp.sum(l * l)) for l in leaves) ** 0.5
    assert total_norm > 0


def test_validation_metrics():
    from p3achygo_tpu.train.val import validate

    model = build_model(get_config("tiny"))
    variables = init_params(model, jax.random.PRNGKey(0))
    board, scalars = _dummy_inputs(jax.random.PRNGKey(1), 4)
    targets = _dummy_targets(jax.random.PRNGKey(2), 4)
    out = validate(model, variables, [(board, scalars, targets)],
                   LossCoeffs.rl())
    for key in ("loss", "policy_acc", "policy_acc_top5", "outcome_acc",
                "score_mae", "own_mae"):
        assert key in out and np.isfinite(out[key])
    assert 0.0 <= out["policy_acc"] <= out["policy_acc_top5"] <= 1.0


def test_mish_matches_reference_formula():
    """The 1-exp mish must equal x*tanh(softplus(x)) to float precision
    across the numeric range (incl. large |x| where naive exp overflows)."""
    import jax.numpy as jnp
    import numpy as np
    from p3achygo_tpu.models.blocks import mish

    x = jnp.asarray(np.concatenate([
        np.linspace(-80, 80, 4001),
        np.array([-1e4, -100.0, -0.0, 0.0, 100.0, 1e4])]), jnp.float32)
    ref = x * jnp.tanh(jnp.logaddexp(x, 0.0))
    got = mish(x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)
    assert np.all(np.isfinite(np.asarray(got)))


DATA = os.path.join(os.path.dirname(__file__), "data")


def _flat(tree):
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _golden_variables(golden, prefix="variables/"):
    """Rebuild the nested variable tree stored flat in the fixture."""
    tree = {}
    for key in golden.files:
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(golden[key])
    return tree


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(DATA, "model_golden_tiny.npz")) as g:
        yield {k: g[k] for k in g.files}, _golden_variables(g)


@pytest.mark.parametrize("train", [False, True])
def test_golden_forward(golden, train):
    """The tiny config's outputs on fixed inputs and variables equal the
    ones the model zoo's original definition produced (and, in train
    mode, its updated batch statistics)."""
    arrays, variables = golden
    model = build_model(get_config("tiny"))
    planes, scalars = arrays["input/planes"], arrays["input/scalars"]
    with jax.default_matmul_precision("highest"):
        if train:
            out, mutated = model.apply(variables, planes, scalars, train=True,
                                       mutable=["batch_stats"])
            for k, v in _flat(mutated["batch_stats"]).items():
                np.testing.assert_allclose(
                    np.asarray(v), arrays[f"train_batch_stats/{k}"],
                    rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            out = model.apply(variables, planes, scalars, train=False)
    tag = "train" if train else "eval"
    for field, value in out._asdict().items():
        np.testing.assert_allclose(np.asarray(value),
                                   arrays[f"{tag}/{field}"],
                                   rtol=1e-5, atol=1e-5, err_msg=field)


def test_golden_init_tree_matches_stored_tree(golden):
    """init_params builds the stored tree: same paths, shapes, dtypes."""
    _, variables = golden
    model = build_model(get_config("tiny"))
    fresh = init_params(model, jax.random.PRNGKey(0))
    want = {k: (v.shape, v.dtype) for k, v in _flat(variables).items()}
    got = {k: (v.shape, v.dtype) for k, v in _flat(fresh).items()}
    assert got == want


with open(os.path.join(DATA, "param_tree_manifest.json")) as _f:
    MANIFEST = json.load(_f)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_param_tree_manifest(name):
    """Every config's variable tree keeps its paths, shapes and dtypes
    (checkpoints and nn/serve.py read weights by these names)."""
    model = build_model(get_config(name))
    shapes = jax.eval_shape(lambda k: init_params(model, k),
                            jax.random.PRNGKey(0))
    got = {k: [list(v.shape), str(v.dtype)] for k, v in _flat(shapes).items()}
    assert got == MANIFEST[name]


def test_init_statistics():
    """Initialisers: lecun-normal kernels (std ~ 1/sqrt(fan_in)), zero
    biases, BN scale 1 / bias 0 / mean 0 / var 1, zero gamma_output."""
    model = build_model(get_config("b8c64"))
    v = init_params(model, jax.random.PRNGKey(3))
    p, s = v["params"], v["batch_stats"]
    k = np.asarray(p["bottleneck_res_0"]["inner_0"]["Conv_0"]["kernel"])
    fan_in = k.shape[0] * k.shape[1] * k.shape[2]
    assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.1
    np.testing.assert_array_equal(np.asarray(p["init_game_layer"]["bias"]), 0)
    bn = p["bottleneck_res_0"]["reduce"]["BatchNorm_0"]
    np.testing.assert_array_equal(np.asarray(bn["scale"]), 1)
    np.testing.assert_array_equal(np.asarray(bn["bias"]), 0)
    st = s["bottleneck_res_0"]["reduce"]["BatchNorm_0"]
    np.testing.assert_array_equal(np.asarray(st["mean"]), 0)
    np.testing.assert_array_equal(np.asarray(st["var"]), 1)
    np.testing.assert_array_equal(
        np.asarray(p["value_head"]["gamma_output"]["kernel"]), 0)
    # distinct layers get distinct draws
    assert not np.allclose(
        np.asarray(p["bottleneck_res_0"]["reduce"]["Conv_0"]["kernel"]),
        np.asarray(p["bottleneck_res_1"]["reduce"]["Conv_0"]["kernel"]))
