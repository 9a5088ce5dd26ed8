"""Batch-size sweep of the official bench (VERDICT r2 item 1c / r3 weak #8).

Runs bench.py at B in {1024, 2048, 4096} sequentially IN-PROCESS-SEPARATE
invocations (one GPU process at a time) and records the curve. Each new B
is a fresh XLA program (slow first compile through the relay; cached
afterwards).

Usage: python benchmarks/bench_batch_sweep.py [B ...]  (GPU)
"""
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def main():
    bs = [int(b) for b in sys.argv[1:]] or [1024, 2048, 4096]
    results = []
    for b in bs:
        env = dict(os.environ, BENCH_BATCH=str(b))
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench.py")],
            env=env, capture_output=True, text=True, timeout=7200)
        line = [l for l in out.stdout.splitlines() if l.startswith("{")]
        if not line:
            print(f"B={b}: FAILED\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
            continue
        rec = json.loads(line[-1])
        rec["batch"] = b
        results.append(rec)
        print(json.dumps(rec), flush=True)
    with open(os.path.join(ROOT, "results", "bench_batch_sweep.json"),
              "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
