"""Micro-benchmark: does partner-index LOCALITY change GPU gather cost?

The flagship solver's hot op is the (R, N)-index row gather of the packed
(N, 8) body state.  If gather throughput improves when the indices are
clustered near the row position (L2/HBM locality), a cell-order body sort
at rebuild time pays; if the cost is a flat per-index constant, it does
not.  Each pattern is timed as the median of ``--iters`` calls, each
ending in ``block_until_ready``; the run stops unless JAX's first device
is a GPU, and prints the card it ran on.

Patterns measured at (r, n) = (9, 100k):
  random   — uniform indices (worst case)
  grid     — the REAL flagship pattern: partners of a settled 12-layer
             pile in scene build order (x-major: z,y neighbors close,
             x neighbors +-1100 rows)
  local    — iota + uniform(-64, 64) (what a cell sort would produce)
  iota     — partner == self row (best case; XLA may shortcut)

Usage: python scripts/micro_gather_locality.py [--n 100000]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu.utils.runtime import (device_info, enable_compile_cache,
                                   require_gpu)


def timeit(f, args, iters):
    """Median milliseconds per call (the first call compiles)."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--r", type=int, default=9)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    try:
        require_gpu()
    except RuntimeError as e:
        sys.exit(f"micro_gather_locality: {e}")
    enable_compile_cache()
    print(f"device {device_info()}", flush=True)
    n, r = args.n, args.r
    rng = np.random.default_rng(0)

    T = jnp.asarray(rng.standard_normal((n + 1, 8)), jnp.float32)

    iota = np.arange(n, dtype=np.int64)[None, :].repeat(r, axis=0)
    patterns = {
        "random": rng.integers(0, n, (r, n)),
        "local64": np.clip(iota + rng.integers(-64, 65, (r, n)), 0, n - 1),
        "local1k": np.clip(iota + rng.integers(-1024, 1025, (r, n)),
                           0, n - 1),
        "iota": iota,
    }
    # the real settled-pile pattern: partners from the flagship scene
    try:
        import functools
        from mgf_tpu.scenes import stress_scene
        from mgf_tpu.world import step
        world, cfg = stress_scene(n) if n <= 100_000 else (None, None)
        f = jax.jit(functools.partial(step, cfg=cfg))
        for _ in range(300):
            world, m = f(world)
        bp = world.bp
        pt = np.asarray(bp.partner).T[:r]          # (r, n)
        ok = np.asarray(bp.ok).T[:r]
        patterns["grid"] = np.where(ok, pt, iota[:r])
        med = np.median(np.abs(patterns["grid"] - iota[:r]))
        print(f"grid pattern: median |partner - self| = {med:.0f}",
              flush=True)
    except Exception as e:
        print(f"grid pattern skipped: {e!r}", flush=True)

    def rowm(T, idx):
        g = T[idx]                          # (R, N, 8)
        return g[..., 0] + g[..., 3] * 2.0 + g[..., 5]

    jf = jax.jit(rowm)
    for name, p in patterns.items():
        idx = jnp.asarray(p.astype(np.int32))
        print(f"{name:8s} ({r},{n}) row gather: "
              f"{timeit(jf, (T, idx), args.iters):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
