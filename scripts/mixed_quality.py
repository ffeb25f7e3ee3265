"""Mixed-mode settled quality: cap_manifold "mid" vs "ends" at 10k.

Single-midpoint capsule manifolds let parallel stacks
rock (settled max pen ~0.52); the endpoint-pair extension should hold
<= 0.25.  Prints pen/overflow/contacts every 60 steps per config plus
steps/s so the quality-vs-cost tradeoff is visible.

Usage: python scripts/mixed_quality.py [--bodies 10000] [--steps 420]
"""
import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from mgf_tpu.scenes import stress_scene
from mgf_tpu.world import step


def probe(name, cfg, world, steps):
    f = jax.jit(functools.partial(step, cfg=cfg))
    w, m = f(world)
    jax.block_until_ready(w)
    t0 = time.perf_counter()
    out = [name]
    for s in range(steps):
        w, m = f(w)
        if (s + 1) % 60 == 0:
            mm = jax.tree_util.tree_map(np.asarray, m)
            out.append(f"s{s+1}: pen={float(mm['max_penetration']):.3f} "
                       f"of={int(mm['broadphase_overflow'])} "
                       f"c={int(mm['num_contacts'])}")
    _ = np.asarray(w.bodies.x.y)
    dt = time.perf_counter() - t0
    out.append(f"{steps / dt:.1f} steps/s")
    print("\n  ".join(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=420)
    args = ap.parse_args()

    world, cfg = stress_scene(args.bodies, mixed=True)
    probe("mid (reference single-midpoint)",
          cfg._replace(cap_manifold="mid"), world, args.steps)
    probe("ends (endpoint-pair extension)",
          cfg._replace(cap_manifold="ends"), world, args.steps)


if __name__ == "__main__":
    main()
