"""Per-fusion breakdown of model.apply at search width + HLO op mapping.

Follow-up to trace_model.py, whose coarse aggregate buckets most of the
time into 'fusion.*' — this prints each fusion's time AND greps the compiled
HLO for that fusion's computation body so we can see which model ops it
streams (BN/mish chains, residual adds, head reductions...).

Usage: python benchmarks/trace_model_fine.py [W] (GPU, one process)
"""
import glob
import gzip
import json
import os
import re
import sys
import time
from collections import defaultdict

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def fusion_times(outdir):
    files = glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                      recursive=True)
    latest = max(files, key=os.path.getmtime)
    with gzip.open(latest, "rt") as f:
        trace = json.load(f)
    by_name = defaultdict(float)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name", "")
        if any(k in name for k in ("fusion", "convolution", "copy", "while",
                                   "custom", "reduce", "dot", "transpose",
                                   "scatter", "dynamic", "all-")):
            by_name[name] += ev.get("dur", 0) / 1e3
    return by_name


def describe_fusion(hlo_text, fusion_name, max_lines=14):
    """Pull the computation body a fusion calls, summarize op kinds/shapes."""
    m = re.search(
        rf'^\s*(?:ROOT )?%?{re.escape(fusion_name)} = \S+ fusion\((.*?)\), '
        rf'kind=(\S+), calls=%?([\w\.\-]+)', hlo_text, re.M)
    if not m:
        return ["  (fusion instr not found in HLO)"]
    called = m.group(3)
    cm = re.search(rf'^%?{re.escape(called)} [^\n]*\{{(.*?)^\}}', hlo_text,
                   re.M | re.S)
    if not cm:
        return [f"  kind={m.group(2)} calls={called} (body not found)"]
    ops = defaultdict(int)
    big_shapes = defaultdict(int)
    for line in cm.group(1).splitlines():
        om = re.search(r'= (\S+?)\[', line)
        if not om:
            continue
        opm = re.search(r'\] (\w[\w\-]*)\(', line)
        op = opm.group(1) if opm else "?"
        if op in ("parameter", "constant"):
            continue
        ops[op] += 1
        sm = re.search(r'= (\S+?\[[\d,]*\])', line)
        if sm:
            big_shapes[sm.group(1)] += 1
    out = [f"  kind={m.group(2)}"]
    out.append("  ops: " + ", ".join(
        f"{k}x{v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])))
    top = sorted(big_shapes.items(),
                 key=lambda kv: -eval(kv[0].split('[')[1][:-1].replace(',', '*') or '0')
                 if kv[0].endswith(']') and kv[0].split('[')[1][:-1] else 0)[:4]
    out.append("  shapes: " + ", ".join(f"{s} x{c}" for s, c in top))
    return out[:max_lines]


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

    hlo = jax.jit(fwd).lower(planes, scalars).compile().as_text()
    with open(f"/tmp/model_hlo_{W}.txt", "w") as f:
        f.write(hlo)
    print(f"HLO -> /tmp/model_hlo_{W}.txt ({len(hlo)} bytes)")

    outdir = f"/tmp/prof_model_fine_{W}"
    with jax.profiler.trace(outdir):
        out = fwd(planes, scalars)
        jax.block_until_ready(out)
    times = fusion_times(outdir)
    total = sum(times.values())
    print(f"total attributed: {total:.1f} ms; top fusions:")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:8.2f} ms  {name}")
        if ms > 3.0 and "fusion" in name:
            for line in describe_fusion(hlo, name):
                print(f"    {line}")


if __name__ == "__main__":
    main()
