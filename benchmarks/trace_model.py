"""Trace model.apply at search width; aggregate hot fusions by op kind.

Finds where the model's time at W=15360 goes beyond the convolutions
(decompose_sweep.py follow-up).

Usage: python benchmarks/trace_model.py [W] (GPU, one process)
"""
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def aggregate(outdir, topn=25):
    files = glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                      recursive=True)
    latest = max(files, key=os.path.getmtime)
    with gzip.open(latest, "rt") as f:
        trace = json.load(f)
    by_name = defaultdict(float)
    total = 0.0
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        dur = ev.get("dur", 0) / 1e3
        if any(k in name for k in ("fusion", "convolution", "copy", "while",
                                   "custom", "reduce", "dot", "transpose",
                                   "scatter", "dynamic", "cholesky", "all-")):
            by_name[name.split(".")[0]] += dur
            total += dur
    print(f"total attributed: {total:.1f} ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:topn]:
        print(f"  {ms:9.2f} ms  {name}")


def main():
    from p3achygo_tpu.models import build_model, get_config, init_params

    W = int(sys.argv[1]) if len(sys.argv) > 1 else 15360
    model = build_model(get_config("b12c128btl3"), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))

    planes = jnp.zeros((W, 19, 19, 15), jnp.float32)
    scalars = jnp.zeros((W, 8), jnp.float32)

    @jax.jit
    def fwd(planes, scalars):
        return model.apply(variables, planes, scalars, train=False)

    out = fwd(planes, scalars)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(4):
        out = fwd(planes, scalars)
    jax.block_until_ready(out)
    print(f"model.apply W={W}: {(time.time()-t0)/4*1000:.1f} ms", flush=True)

    outdir = f"/tmp/prof_model_{W}"
    with jax.profiler.trace(outdir):
        out = fwd(planes, scalars)
        jax.block_until_ready(out)
    aggregate(outdir)


if __name__ == "__main__":
    main()
