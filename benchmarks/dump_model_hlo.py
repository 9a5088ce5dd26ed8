"""Dump compiled HLO of model.apply at search width for fusion analysis.

Usage: python benchmarks/dump_model_hlo.py [W] [config] (GPU, one process)
Writes /tmp/model_hlo_{config}_{W}.txt and prints a fusion census:
per-fusion op mix and output bytes, to see which elementwise passes are
NOT fused into convolutions (BN/mish memory streaming).
"""
import os
import re
import sys
from collections import defaultdict

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from p3achygo_tpu import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=5)


def main():
    from p3achygo_tpu.models import build_model, get_config, init_params

    W = int(sys.argv[1]) if len(sys.argv) > 1 else 15360
    cfg = sys.argv[2] if len(sys.argv) > 2 else "b12c128btl3"
    model = build_model(get_config(cfg), dtype=jnp.bfloat16)
    variables = init_params(model, jax.random.PRNGKey(0))

    planes = jnp.zeros((W, 19, 19, 15), jnp.float32)
    scalars = jnp.zeros((W, 8), jnp.float32)

    def fwd(planes, scalars):
        return model.apply(variables, planes, scalars, train=False)

    compiled = jax.jit(fwd).lower(planes, scalars).compile()
    txt = compiled.as_text()
    path = f"/tmp/model_hlo_{cfg}_{W}.txt"
    with open(path, "w") as f:
        f.write(txt)
    print(f"wrote {path} ({len(txt)} bytes)")

    # Census: top-level instructions in the entry computation.
    counts = defaultdict(int)
    for m in re.finditer(r"^\s+\S+ = (\w[\w.-]*)\(", txt, re.M):
        counts[m.group(1)] += 1
    for k in sorted(counts, key=lambda k: -counts[k])[:20]:
        print(f"  {counts[k]:5d}  {k}")


if __name__ == "__main__":
    main()
