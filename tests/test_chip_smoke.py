"""chip_smoke.py's phases at tiny sizes on the CPU (a rehearsal of the
script), and its refusal to run without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from p3achygo_tpu.game import random_positions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def positions():
    return random_positions(jax.random.PRNGKey(0), 48, 40)


def test_positions_are_mid_game(positions):
    moves = jax.device_get(positions.move_count)
    assert moves.shape == (48,)
    assert 4 <= moves.min() and moves.max() <= 40 and moves.max() > moves.min()


def test_phase_liberties(positions):
    out = chip_smoke.phase_liberties(positions, reps=2)
    assert out["width"] == 48 and out["pass_ms"] > 0


def test_phase_forward(positions):
    out = chip_smoke.phase_forward(positions, n_f32=8, n_bf16=24,
                                   config="tiny")
    assert out["bf16_top1"] >= 0.99


def test_phase_selfplay():
    out = chip_smoke.phase_selfplay(batch=8, warmup=1, timed=16,
                                    check_plies=2, det_plies=2,
                                    config="tiny")
    assert out["moves_per_s"] > 0 and out["deterministic"]


def test_phase_train():
    out = chip_smoke.phase_train(batch=16, steps=3, parity_batch=4,
                                 config="tiny")
    assert out["loss_last"] < out["loss_first"]


@pytest.mark.parametrize("case,total,leaf", [
    ("exact", 0.0, 0.0),
    ("stale", 0.5 ** 0.5, 1.0),      # one of two leaves never updated
    ("flipped", 2 ** 0.5, 2.0),      # one of two leaves updated backwards
])
def test_update_errors(case, total, leaf):
    """The parity measure reads a leaf the step left unchanged as 1 and a
    reversed update as 2; a leaf whose reference update is zero up to
    rounding is left to the total."""
    x0 = {"a": np.ones(64), "b": np.zeros(64), "c": np.ones(4)}
    ref = {"a": x0["a"] + 1e-4, "b": x0["b"] + 1e-4,
           "c": x0["c"] + 1e-18}
    got = dict(ref)
    if case == "stale":
        got["b"] = x0["b"]
    elif case == "flipped":
        got["b"] = x0["b"] - 1e-4
    out = chip_smoke.update_errors(x0, got, ref)
    assert set(out["leaves"]) == {"['a']", "['b']"}
    np.testing.assert_allclose(out["total"], total, atol=1e-9)
    np.testing.assert_allclose(out["leaves"]["['b']"], leaf, atol=1e-9)
    assert out["leaves"]["['a']"] < 1e-9


def test_phase_gtp():
    out = chip_smoke.phase_gtp(config="tiny", n=8, k=4)
    assert len(out["moves"]) == 3


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole script on the card, in a child process that owns it
    (this process stays on the CPU). Run: python -m pytest tests -m gpu -n 0."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU: chip_smoke.py runs only on the card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.splitlines()[-1])["ok"] is True
