"""Proof that the system's main path runs on one GPU, at b12c128btl3's full
width, through the entry points a user calls.

    python chip_smoke.py [--seed N]      # one GPU: every phase below
    python chip_smoke.py --multi         # four GPUs: the dp x tp path only

Phases, in order, all in this one process on jax.devices()[0]; every CPU
reference runs in the same process on jax.devices("cpu")[0]:

1. device     platform, card name and power limit, JAX version, flags.
2. liberties  the batched liberty pass and legality masks on 15,360
              random mid-game positions: exact equality with the CPU; the
              pass's time on the card.
3. forward    f32 on the card vs the CPU; the serving graph (nn/serve.py)
              vs model.apply; the bf16 serving forward vs the f32 forward.
4. selfplay   bench.py's configuration: compile time, moves/s, peak
              memory; move legality, policy targets, finite values;
              whether two runs from one seed play the same moves.
5. train      the RL train step: 10 steps lower the loss on a fixed
              batch; one f32 step on the card vs the same step in
              float64 on the CPU.
6. gtp        GtpService over make_eval_fn: boardsize, clear_board,
              genmove, play, genmove.

Every failed check raises, so the script exits non-zero. With no GPU it
exits non-zero before any phase. The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Each phase is a function of its sizes, so the tests run them on the CPU
at tiny sizes; only `main` insists on a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__
import bench
from p3achygo_tpu import compile_cache
from p3achygo_tpu.data.pipeline import prepare_batch
from p3achygo_tpu.features import batched_features
from p3achygo_tpu.game import (
    MOVE_VALID,
    legal_mask,
    legal_mask_batch,
    point_liberties_batch,
    random_positions,
    step,
)
from p3achygo_tpu.gtp.service import (
    GtpConfig,
    GtpService,
    action_to_gtp_vertex,
    gtp_vertex_to_action,
)
from p3achygo_tpu.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu.models import LossCoeffs, build_model, get_config, init_params
from p3achygo_tpu.nn.serve import serve_forward
from p3achygo_tpu.rl.config import RunConfig
from p3achygo_tpu.rl.loop import make_optimizer
from p3achygo_tpu.selfplay.loop import finished_mask
from p3achygo_tpu.train.step import create_train_state, make_train_step

CONFIG = "b12c128btl3"
# The fast tier's leaf width at bench.py's configuration: 768 boards x
# k=5 x visit_group 4.
LIBERTY_WIDTH = 15360
HIGHEST = "highest"
# A bf16 value's step is up to 2^-7 of its magnitude, and the serving graph
# rounds to bf16 in every block, so its logits are off by a few such steps:
# the bf16 top-1 check asks agreement only where the f32 top-two margin
# exceeds four steps of the top logit.
TOP1_MARGIN = 2.0 ** -5


def _cpu():
    return jax.devices("cpu")[0]


def _to_cpu(tree):
    return jax.device_put(tree, _cpu())


def _to_f64(tree):
    """Host copy with every float leaf widened to float64 (call inside
    `jax.enable_x64`)."""
    def widen(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) \
            else x
    return jax.tree_util.tree_map(widen, tree)


def _compile_counter():
    """A list that grows by one entry per XLA backend compile."""
    events = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: events.append(name)
        if name.endswith("backend_compile_duration") else None)
    return events


def _take(tree, n):
    return jax.tree_util.tree_map(lambda x: x[:n], tree)


def _require_finite(tree, what: str):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf, np.float32)
        assert np.isfinite(a).all(), \
            f"{what}: non-finite values in {jax.tree_util.keystr(path)}"


# ---------------------------------------------------------------- phase 1
def phase_device(gpu: str, cache_dir: str) -> dict:
    d = jax.devices()[0]
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(jax.devices())}")
    flags = os.environ.get("XLA_FLAGS", "")
    print(f"jax {jax.__version__}; XLA_FLAGS={flags!r}")
    print(f"compile cache: {cache_dir}")
    print(f"gpu (name, power.limit): {gpu}")
    return bench.device_record()


# ---------------------------------------------------------------- phase 2
def phase_liberties(states, reps: int = 20) -> dict:
    libs_fn = jax.jit(point_liberties_batch)
    mask_fn = jax.jit(legal_mask_batch)
    libs = np.asarray(libs_fn(states.stones, states.chain_id))
    mask = np.asarray(mask_fn(states))
    cpu_states = _to_cpu(states)
    with jax.default_device(_cpu()):
        ref_libs = np.asarray(libs_fn(cpu_states.stones, cpu_states.chain_id))
        ref_mask = np.asarray(mask_fn(cpu_states))
    np.testing.assert_array_equal(libs, ref_libs, "liberties: card != CPU")
    np.testing.assert_array_equal(mask, ref_mask, "legal masks: card != CPU")
    stones = np.asarray(states.stones) != 0
    assert (libs[stones] >= 1).all(), "a stone on the board has no liberty"
    assert (libs[~stones] == 0).all(), "an empty point has a liberty count"

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        libs_fn(states.stones, states.chain_id).block_until_ready()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(times)
    width = int(states.stones.shape[0])
    print(f"liberties: W={width} exact match with CPU (liberties and legal "
          f"masks), {int(stones.sum())} stones; one jitted pass "
          f"{ms:.3f} ms median of {reps}")
    return {"width": width, "pass_ms": ms}


# ---------------------------------------------------------------- phase 3
def _perturb(variables, seed: int):
    """Random BN statistics and params around the init, so that every
    folded term of the serving graph is nonzero."""
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 4096))
    stats = jax.tree_util.tree_map(
        lambda x: x + jax.random.uniform(next(keys), x.shape, x.dtype,
                                         0.01, 0.4), variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(next(keys), x.shape, x.dtype),
        variables["params"])
    return {"params": params, "batch_stats": stats}


def phase_forward(states, n_f32: int = 64, n_bf16: int = 1024,
                  config: str = CONFIG, seed: int = 0) -> dict:
    cfg = get_config(config)
    m32 = build_model(cfg, dtype=jnp.float32)
    m16 = build_model(cfg, dtype=jnp.bfloat16)
    # Params and BN statistics perturbed around the init, for every check.
    variables = _perturb(init_params(m32, jax.random.PRNGKey(seed)), seed + 1)
    planes, scalars = jax.jit(batched_features)(_take(states, n_bf16))
    apply32 = jax.jit(lambda v, p, s: m32.apply(v, p, s, train=False))
    serve32 = jax.jit(lambda v, p, s: serve_forward(m32, v, p, s,
                                                    want_optimistic=True))
    serve16 = jax.jit(lambda v, p, s: serve_forward(m16, v, p, s))
    p64, s64 = planes[:n_f32], scalars[:n_f32]

    with jax.default_matmul_precision(HIGHEST):
        card = apply32(variables, p64, s64)
        with jax.default_device(_cpu()):
            host = apply32(*_to_cpu((variables, p64, s64)))
        _require_finite(card, "f32 forward on the card")
        _require_finite(host, "f32 forward on the CPU")
        for f in ("pi_logits", "outcome_logits", "score_logits"):
            np.testing.assert_allclose(
                np.asarray(getattr(card, f)), np.asarray(getattr(host, f)),
                rtol=1e-4, atol=1e-4, err_msg=f"f32 card vs CPU: {f}")
        for f in ("pi_probs", "outcome_probs", "score_probs"):
            np.testing.assert_allclose(
                np.asarray(getattr(card, f)), np.asarray(getattr(host, f)),
                atol=1e-5, err_msg=f"f32 card vs CPU: {f}")
        f32_dev = float(np.max(np.abs(np.asarray(card.pi_logits)
                                      - np.asarray(host.pi_logits))))

        folded = serve32(variables, p64, s64)
        _require_finite(folded, "f32 serving graph")
        for f in ("pi_logits", "pi_logits_optimistic"):
            np.testing.assert_allclose(
                np.asarray(getattr(folded, f)), np.asarray(getattr(card, f)),
                atol=2e-4, rtol=1e-4, err_msg=f"serve fold f32: {f}")
        for f in ("outcome_probs", "score_probs", "q6_err", "gamma"):
            np.testing.assert_allclose(
                np.asarray(getattr(folded, f)), np.asarray(getattr(card, f)),
                atol=1e-5, err_msg=f"serve fold f32: {f}")
        ref = apply32(variables, planes, scalars)

    low = serve16(variables, planes.astype(jnp.bfloat16), scalars)
    _require_finite(ref, "f32 reference")
    _require_finite(low, "bf16 serving graph")
    ref_logits = np.asarray(ref.pi_logits)
    agree = (np.argmax(np.asarray(low.pi_logits), -1)
             == np.argmax(ref_logits, -1))
    top2 = np.sort(ref_logits, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > TOP1_MARGIN * np.abs(top2[:, 1])
    assert decided.mean() >= 0.5, \
        f"only {decided.mean():.3f} of positions have a decided top-1"
    top1 = float(agree[decided].mean())
    assert top1 >= 0.99, f"bf16 serving top-1 agreement {top1} < 0.99"
    bf16_dev = float(np.max(np.abs(
        np.asarray(jax.nn.softmax(low.pi_logits, -1))
        - np.asarray(ref.pi_probs))))
    assert bf16_dev <= 0.02, f"bf16 serving probabilities off by {bf16_dev}"

    default_dev = float(np.max(np.abs(
        np.asarray(apply32(variables, p64, s64).pi_logits)
        - np.asarray(card.pi_logits))))
    print(f"forward ({config}): f32 card vs CPU at 'highest' on {n_f32} "
          f"positions, max |dlogit| {f32_dev:.3e} (rtol 1e-4, atol 1e-4; "
          f"probs atol 1e-5); serve fold f32 ok; bf16 serving on {n_bf16}: "
          f"top-1 agreement {top1:.4f} (>= 0.99) on the {int(decided.sum())} "
          f"positions whose f32 top-two margin exceeds {TOP1_MARGIN:.4g} of "
          f"the top logit ({float(agree.mean()):.4f} on all), max |dprob| "
          f"{bf16_dev:.3e} (<= 0.02); default precision vs 'highest': "
          f"max |dlogit| {default_dev:.3e} (information only)")
    return {"f32_max_dlogit": f32_dev, "bf16_top1": top1,
            "bf16_decided": float(decided.mean()),
            "bf16_top1_all": float(agree.mean()),
            "bf16_max_dprob": bf16_dev, "default_max_dlogit": default_dev}


# ---------------------------------------------------------------- phase 4
_step_batch = jax.jit(jax.vmap(step))


def _check_ply(before, after, cfg):
    """The moves one ply recorded are legal, its policy targets are
    distributions and its values are finite, for every active board."""
    states = before[0]
    buf = after[1]
    active = np.asarray(~finished_mask(states, cfg))
    b = np.arange(active.shape[0])
    t = np.clip(np.asarray(states.move_count), 0, cfg.max_game_len - 1)
    move = jnp.asarray(np.asarray(buf.move)[b, t].astype(np.int32))
    status = np.asarray(_step_batch(states, move)[1])
    bad = active & (status != MOVE_VALID)
    assert not bad.any(), f"illegal moves played: status {status[bad][:8]}"
    pi_sum = np.asarray(buf.pi)[b, t].sum(-1)[active]
    assert np.all(np.abs(pi_sum - 1.0) <= 1e-5), \
        f"policy targets sum to {pi_sum.min()}..{pi_sum.max()}"
    for f in ("root_q_outcome", "root_score"):
        v = np.asarray(getattr(buf, f))[b, t][active]
        assert np.isfinite(v).all(), f"non-finite {f}"
    return int(active.sum())


def phase_selfplay(batch: int = 1024, warmup: int = 32, timed: int = 16,
                   check_plies: int = 4, det_plies: int = 4,
                   visit_group: int = 4, config: str = CONFIG,
                   seed: int = 0, gpu: str = "") -> dict:
    sp = bench.build_selfplay(batch, visit_group, config=config, seed=seed)
    carry = sp.init(jax.random.PRNGKey(seed + 1))
    t0 = time.perf_counter()
    step_c = sp.sp_step.lower(*carry).compile()
    recycle_c = sp.recycle.lower(*carry).compile()
    compile_s = time.perf_counter() - t0
    run = partial(bench.run_plies, sp, sp_step=step_c, recycle=recycle_c)

    carry, _ = run(carry, warmup)
    compiles = _compile_counter()
    t0 = time.perf_counter()
    carry, counts = run(carry, timed)
    dt = time.perf_counter() - t0
    assert not compiles, f"compiled inside the timed plies: {compiles}"
    moves = sum(int(c) for c in counts)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")

    checked = 0
    for _ in range(check_plies):
        nxt = step_c(*carry)
        checked += _check_ply(carry, nxt, sp.cfg)
        carry = nxt

    runs = []
    for _ in range(2):
        c = carry
        for _ in range(det_plies):
            c = step_c(*c)
        runs.append((np.asarray(c[1].move), np.asarray(c[0].stones)))
    same = all(np.array_equal(a, b) for a, b in zip(*runs))

    tag = f"[{gpu}] " if gpu else ""
    print(f"{tag}selfplay ({config} bf16, "
          f"serve_fold={bench.SERVE_FOLD}, B={batch}, 25% "
          f"n=128/k=8 + 75% n=32/k=5, visit_group={visit_group}, reuse): "
          f"compile {compile_s:.1f} s; {warmup} warm-up plies, then "
          f"{timed} timed plies with {timed // bench.RESET_EVERY} recycle: "
          f"{moves} moves in {dt:.3f} s = {moves / dt:.2f} moves/s "
          f"({1e3 * dt / timed:.1f} ms/ply); no compile in the window")
    print(f"{tag}selfplay peak_bytes_in_use: {peak}")
    print(f"selfplay checks: {checked} moves over {check_plies} plies legal, "
          f"policy targets sum to 1 +- 1e-5, values and scores finite")
    print(f"selfplay determinism: {det_plies} plies twice from one state -> "
          f"moves and stones {'MATCH' if same else 'DIFFER'}")
    return {"compile_s": compile_s, "moves_per_s": moves / dt,
            "ply_ms": 1e3 * dt / timed, "peak_bytes": peak,
            "deterministic": same}


# ---------------------------------------------------------------- phase 5
# Limits of the f32 train-step parity. They bound the error of the update
# (params after one step less params before) on the card against the same
# step in float64 on the CPU, in relative L2: over all params, and per
# leaf. A leaf is held to its own limit when its reference update is wider
# than ROUNDING_STEPS f32 rounding steps of its values (so the f32 params
# can hold it), and its RMS is at least MIN_LEAF_SHARE of the whole
# update's (so it is no gradient that is zero up to rounding, such as a
# bias shared by all softmax logits).
UPDATE_REL_L2 = 5e-2
LEAF_UPDATE_REL_L2 = 0.5
ROUNDING_STEPS = 10
MIN_LEAF_SHARE = 1e-3


def update_errors(x0, got, ref) -> dict:
    """Relative L2 error of the update `got - x0` against `ref - x0`, over
    all params ("total") and per leaf ("leaves", {path: error}) for the
    leaves held to their own limit."""
    rows = []
    for (path, a), b, x in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                               jax.tree_util.tree_leaves(ref),
                               jax.tree_util.tree_leaves(x0)):
        x = np.asarray(x, np.float64)
        err = float(np.linalg.norm(np.asarray(a, np.float64) - b))
        norm = float(np.linalg.norm(np.asarray(b, np.float64) - x))
        rows.append((jax.tree_util.keystr(path), err, norm,
                     float(np.linalg.norm(x)), x.size))
    num = sum(r[1] ** 2 for r in rows)
    den = sum(r[2] ** 2 for r in rows)
    rms = (den / sum(r[4] for r in rows)) ** 0.5
    leaves = {key: err / norm for key, err, norm, x_norm, size in rows
              if norm > ROUNDING_STEPS * 2.0 ** -24 * x_norm
              and norm / size ** 0.5 >= MIN_LEAF_SHARE * rms}
    return {"total": (num / den) ** 0.5, "leaves": leaves}


def phase_train(batch: int = 256, steps: int = 10, parity_batch: int = 32,
                config: str = CONFIG, seed: int = 0) -> dict:
    tx = make_optimizer(RunConfig(model_config=config))
    prep = jax.jit(partial(prepare_batch, augment=False))
    key = jax.random.PRNGKey(seed)

    # The RL loop's train step (bf16 compute, f32 params) on a fixed batch.
    model = build_model(get_config(config), dtype=jnp.bfloat16)
    state = create_train_state(init_params(model, key), tx)
    train_step = jax.jit(make_train_step(model, tx, LossCoeffs.rl()))
    planes, scalars, targets = prep(
        key, __graft_entry__.synthetic_batch(batch, seed))
    losses = []
    for _ in range(steps + 1):
        new_state, out = train_step(state, planes, scalars, targets)
        losses.append(float(out["loss"]))
        state = new_state
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"

    # One f32 step on the card at 'highest' against the same step in
    # float64 on the CPU. The CPU's own f32 step is measured beside it: its
    # f32 reductions lose the score head's cancelling sums, which is why
    # the reference is float64.
    m32 = build_model(get_config(config), dtype=jnp.float32)
    step32 = jax.jit(make_train_step(m32, tx, LossCoeffs.rl()))
    s0 = create_train_state(init_params(m32, key), tx)
    args = (s0,) + tuple(prep(
        key, __graft_entry__.synthetic_batch(parity_batch, seed + 1)))
    with jax.default_matmul_precision(HIGHEST):
        card_state, card_out = step32(*args)
        with jax.default_device(_cpu()):
            cpu_state, _ = jax.device_get(step32(*_to_cpu(args)))
    with jax.enable_x64(True), jax.default_device(_cpu()):
        m64 = build_model(get_config(config), dtype=jnp.float64)
        step64 = jax.jit(make_train_step(m64, tx, LossCoeffs.rl()))
        ref_state, ref_out = step64(*_to_f64(args))
        ref_state, ref_out = jax.device_get((ref_state, ref_out))
    card_loss, ref_loss = float(card_out["loss"]), float(ref_out["loss"])
    np.testing.assert_allclose(card_loss, ref_loss, rtol=1e-4,
                               err_msg="train loss: card vs CPU f64")
    card = update_errors(s0.params, card_state.params, ref_state.params)
    cpu = update_errors(s0.params, cpu_state.params, ref_state.params)
    worst_leaf = max(card["leaves"], key=card["leaves"].get)
    assert card["total"] <= UPDATE_REL_L2, \
        f"card's update off by {card['total']:.3e} in relative L2"
    assert card["leaves"][worst_leaf] <= LEAF_UPDATE_REL_L2, \
        (f"card's update of {worst_leaf} off by "
         f"{card['leaves'][worst_leaf]:.3e} in relative L2")
    cpu_worst = max(cpu["leaves"], key=cpu["leaves"].get)
    print(f"train ({config}, RL optimizer): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {steps} steps at batch {batch}; f32 step "
          f"at batch {parity_batch} vs CPU f64: loss {card_loss:.6f} vs "
          f"{ref_loss:.6f} (rtol 1e-4); the card's update (at 'highest') "
          f"off by {card['total']:.3e} in relative L2 (<= {UPDATE_REL_L2}), "
          f"worst of {len(card['leaves'])} leaves {worst_leaf} "
          f"{card['leaves'][worst_leaf]:.3e} (<= {LEAF_UPDATE_REL_L2}); "
          f"the CPU's f32 update off by {cpu['total']:.3e}, worst leaf "
          f"{cpu_worst} {cpu['leaves'][cpu_worst]:.3e} (information only)")
    return {"loss_first": losses[0], "loss_last": losses[-1],
            "parity_loss": (card_loss, ref_loss), "card": card, "cpu": cpu}


# ---------------------------------------------------------------- phase 6
def phase_gtp(config: str = CONFIG, n: int = 128, k: int = 8,
              seed: int = 0) -> dict:
    model = build_model(get_config(config), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(seed))
    service = GtpService(make_eval_fn(model, variables),
                         GtpConfig(search=SearchParams(n=n, k=k,
                                                       noise_scale=0.0)))

    def send(line):
        ok, reply = service.handle(line)
        assert ok, f"GTP {line!r} failed: {reply}"
        return reply

    def genmove():
        legal = np.asarray(legal_mask(service.state))
        t0 = time.perf_counter()
        vertex = send("genmove b")
        secs = time.perf_counter() - t0
        action = gtp_vertex_to_action(vertex)
        assert legal[action], f"genmove returned illegal {vertex}"
        return vertex, secs

    send("boardsize 19")
    send("clear_board")
    first, first_s = genmove()
    legal = np.flatnonzero(np.asarray(legal_mask(service.state))[:361])
    reply_w = action_to_gtp_vertex(
        int(np.random.default_rng(seed).choice(legal)))
    send(f"play w {reply_w}")
    second, second_s = genmove()
    print(f"gtp ({config} bf16, n={n}/k={k}): genmove b -> {first} "
          f"({first_s:.1f} s, compile included), play w {reply_w}, "
          f"genmove b -> {second} ({second_s:.2f} s)")
    return {"moves": [first, reply_w, second], "genmove_s": second_s}


# ---------------------------------------------------------------- --multi
def phase_multi(n_devices: int = 4, config: str = CONFIG) -> dict:
    """The dp x tp path (__graft_entry__.dryrun_multichip) on n devices,
    compared with one device in f32 at 'highest'."""
    assert len(jax.devices()) >= n_devices, \
        f"--multi needs {n_devices} devices, found {len(jax.devices())}"
    summary = __graft_entry__.dryrun_multichip(n_devices, config,
                                               precision=HIGHEST)
    print("multi: " + json.dumps(summary))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device dp x tp path and its "
                         "single-device comparison")
    args = ap.parse_args(argv)

    bench.require_gpu()
    cache_dir = compile_cache.enable()
    gpu = bench.gpu_name_and_power()
    t_start = time.perf_counter()
    device = phase_device(gpu, cache_dir)

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a, **kw))
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    if args.multi:
        timed("multi", phase_multi, 4)
    else:
        states = timed("positions", random_positions,
                       jax.random.PRNGKey(args.seed), LIBERTY_WIDTH, 240)
        libs = timed("liberties", phase_liberties, states)
        print(f"[{gpu}] liberty pass at W={libs['width']}: "
              f"{libs['pass_ms']:.3f} ms")
        timed("forward", phase_forward, states, seed=args.seed)
        del states
        timed("selfplay", phase_selfplay, seed=args.seed, gpu=gpu)
        timed("train", phase_train, seed=args.seed)
        timed("gtp", phase_gtp, seed=args.seed)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
