"""Break the in-search NN eval wrapper into parts: find out where the
featurize + eval cost lives beside the model forward itself.

The search evaluates leaves at lane width W = B_tier * k * visit_group:
fast tier 768*5*4 = 15360, selected tier 256*8*4 = 8192 (first round).
Times, at those widths:
  - the batched liberty pass alone
  - batched_features (no ladders)
  - plane-level symmetrize (current 8x one-hot gather accumulation)
  - STATE-level symmetrize (candidate: flip/transpose selects on the int8
    stone/chain grids BEFORE featurizing — 15x f32 -> 1x int8 traffic)
  - model.apply alone
  - full eval_fn (current) vs full eval_fn_v2 (state-level symmetrize)

Usage: python benchmarks/profile_sweep_parts.py  (GPU, one process)
"""
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def timeit(name, fn, *args, iters=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    ms = (time.time() - t0) / iters * 1000
    print(f"  {name}: {ms:.2f} ms", flush=True)
    return ms


def main():
    from p3achygo_tpu.features import batched_features
    from p3achygo_tpu.game.board import legal_mask, new_state, step
    from p3achygo_tpu.game.symmetry import NUM_SYMMETRIES, SYM_GATHER
    from p3achygo_tpu.mcts.gumbel import make_eval_fn
    from p3achygo_tpu.models import build_model, get_config, init_params
    from p3achygo_tpu.game.board import point_liberties_batch

    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))
    eval_cur = jax.jit(make_eval_fn(model, variables, symmetrize=True))
    eval_nosym = jax.jit(make_eval_fn(model, variables, symmetrize=False))

    B0 = 1024
    states = jax.vmap(lambda _: new_state(7.5))(jnp.arange(B0))
    key = jax.random.PRNGKey(1)

    @jax.jit
    def random_step(states, key):
        lm = jax.vmap(legal_mask)(states)
        mv = jax.random.categorical(key, jnp.where(lm, 0.0, -1e9), axis=-1)
        nxt, _ = jax.vmap(step)(states, mv.astype(jnp.int32))
        return nxt

    for i in range(60):
        key, k = jax.random.split(key)
        states = random_step(states, k)
    jax.block_until_ready(states.stones)

    @jax.jit
    def feats(states):
        return batched_features(states, False)

    @jax.jit
    def libs_only(states):
        return point_liberties_batch(states.stones, states.chain_id)

    @jax.jit
    def sym_planes(planes, h):
        sym = (h % 8).astype(jnp.int32)
        n, H, W_, C = planes.shape
        flat = planes.reshape(n, H * W_, C)
        sym_oh = jax.nn.one_hot(sym, NUM_SYMMETRIES)
        acc = jnp.zeros_like(flat)
        for s in range(NUM_SYMMETRIES):
            acc = acc + sym_oh[:, s, None, None] * flat[:, SYM_GATHER[s], :]
        return acc.reshape(n, H, W_, C)

    def sym_grid(x, s):
        """Per-board D4 transform of [B,19,19] grids via flip/transpose
        selects (matches _transform_grid: col-flip if s>=4, then rot90^k)."""
        k = s % 4
        x = jnp.where((s >= 4)[:, None, None], x[:, :, ::-1], x)
        xt = jnp.swapaxes(x, 1, 2)
        x = jnp.where((k % 2 == 1)[:, None, None], xt, x)
        x = jnp.where(((k == 1) | (k == 2))[:, None, None], x[:, ::-1, :], x)
        x = jnp.where(((k == 2) | (k == 3))[:, None, None], x[:, :, ::-1], x)
        return x

    @jax.jit
    def sym_state(states):
        sym = (states.hash[:, 0] % 8).astype(jnp.int32)
        n = states.stones.shape[0]
        st = sym_grid(states.stones.reshape(n, 19, 19), sym).reshape(n, 361)
        ch = sym_grid(states.chain_id.reshape(n, 19, 19), sym).reshape(n, 361)
        return st, ch

    @jax.jit
    def model_only(planes, scalars):
        return model.apply(variables, planes, scalars, train=False)

    for W in (4096, 8192, 15360):
        idx = jnp.arange(W) % B0
        sts = jax.tree_util.tree_map(lambda x: jnp.take(x, idx, axis=0),
                                     states)
        print(f"W={W}:", flush=True)
        planes, scalars = feats(sts)
        jax.block_until_ready(planes)
        timeit("point_liberties_batch", libs_only, sts)
        timeit("batched_features        ", feats, sts)
        timeit("sym planes (8x one-hot) ", sym_planes, planes, sts.hash[:, 0])
        timeit("sym STATE (flip/select) ", sym_state, sts)
        timeit("model.apply             ", model_only, planes, scalars)
        timeit("eval_fn sym=False       ", eval_nosym, sts)
        timeit("eval_fn sym=True (cur)  ", eval_cur, sts)


if __name__ == "__main__":
    main()
