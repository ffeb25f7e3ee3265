"""Fused solver-sweep kernel vs the jnp inner sweeps, on one GPU.

1. micro: one warm-started 2x6 solve at R=12, N=100,000 (random rows),
   jnp vs the kernel at 32 and 64 bodies per program; parity and median
   time of each;
2. end to end: the headline scene (stress_scene(100_000), chunk 64,
   host-adaptive), settled for --settle steps on the jnp path, then
   windows of 128 steps alternating kernel, jnp, jnp, kernel, kernel, jnp
   with the fastest micro variant; median and spread of each.

    python scripts/solver_kernel_ab.py [--settle 640]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from mgf_tpu.utils.runtime import (device_info, enable_compile_cache,
                                   require_gpu)


def micro(variants, iters=20):
    from mgf_tpu import checks
    from mgf_tpu.ops import solver_sweep as ss
    from mgf_tpu.solver import solve_rows

    rc, v, omega, inv_mass, iso = checks.random_row_system(100_000, 12)
    rng = np.random.default_rng(1)
    warm = tuple(jax.numpy.asarray(rng.uniform(0, 0.3, (12, 100_000)),
                                   jax.numpy.float32) for _ in range(3))
    out = {}
    for name, cfg in variants:
        if cfg is not None:
            ss.BLOCK = cfg
        f = jax.jit(lambda rc, v, o, w: solve_rows(
            rc, v, o, inv_mass, iso, 2, friction_mode="textbook",
            two_phase=False, inner_iters=6, warm=w, return_acc=True,
            pallas_inner=cfg is not None))
        jax.block_until_ready(f(rc, v, omega, warm))
        ts = []
        for _ in range(iters):
            t = time.perf_counter()
            jax.block_until_ready(f(rc, v, omega, warm))
            ts.append(time.perf_counter() - t)
        out[name] = float(np.median(ts)) * 1e3
        print(f"micro {name}: {out[name]:.4f} ms median of {iters}",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--settle", type=int, default=640)
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    info = device_info()
    print(f"device {info}", flush=True)

    from mgf_tpu import checks
    from mgf_tpu.ops import solver_sweep as ss

    variants = [("jnp", None)] + [(f"kernel_b{b}", b) for b in (32, 64)]
    ok = []
    for name, cfg in variants[1:]:
        ss.BLOCK = cfg
        try:
            r = checks.solver_kernel_parity()
            print(f"parity {name}: {r}", flush=True)
            ok.append((name, cfg))
        except Exception as e:          # a variant the compiler refuses
            print(f"parity {name}: FAILED {type(e).__name__}: "
                  f"{str(e)[:400]}", flush=True)
    ms = micro([variants[0]] + ok)
    best = min(ok, key=lambda nc: ms[nc[0]])
    ss.BLOCK = best[1]
    print(f"best variant {best[0]}", flush=True)

    from mgf_tpu.driver import AdaptiveChunkStepper
    from mgf_tpu.scenes import stress_scene
    world, cfg = stress_scene(100_000)
    st = {k: AdaptiveChunkStepper(cfg._replace(pallas_solver=k == "kernel"),
                                  chunk=64, light=True)
          for k in ("kernel", "jnp")}
    t0 = time.perf_counter()
    for s in st.values():
        for f in (s.full, s.hot):
            jax.block_until_ready(f(world))
    print(f"compile {time.perf_counter() - t0:.1f} s", flush=True)
    w = world
    for _ in range(-(-args.settle // 64)):
        w, m = st["jnp"].step_chunk(w)
    jax.block_until_ready(w)
    hot = st["jnp"].hot_on          # one schedule for every window
    rates = {"kernel": [], "jnp": []}
    for k in ("kernel", "jnp", "jnp", "kernel", "kernel", "jnp"):
        f = st[k].hot if hot else st[k].full
        t = time.perf_counter()
        for _ in range(2):
            w, m = f(w)
        jax.block_until_ready(w)
        rates[k].append(128 / (time.perf_counter() - t))
        print(f"window {k}: {rates[k][-1]:.3f} steps/s (hot {hot}, "
              f"contacts {int(np.asarray(m['num_contacts'])[-1])})",
              flush=True)
    summary = {k: {"median": float(np.median(r)), "min": float(min(r)),
                   "max": float(max(r)), "windows": r}
               for k, r in rates.items()}
    print(json.dumps({"micro_ms": ms, "best": best[0], "e2e": summary,
                      "device": info}))


if __name__ == "__main__":
    main()
