"""Test config: the CPU backend with an 8-device virtual mesh.

Must run before jax is imported: tests force the CPU platform so they run
anywhere, in parallel, and never take a GPU.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_TRACEBACK_FILTERING", "off")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent CPU compile cache: the suite jits ~200 programs; caching them
# across runs cuts wall time several-fold and reduces in-process compiler
# churn (cache hits avoid recompiling entirely).
from p3achygo_tpu import compile_cache

compile_cache.enable(".jax_cache_cpu")
