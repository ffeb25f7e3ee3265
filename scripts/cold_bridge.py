"""Matched-N cold-quality bridge: run the ENGINE's
cold-20 configuration (the bench's `stress_cold20` row semantics:
warm_start off, 20 two-phase sweeps — the reference's own schedule,
solver.rs:72-78 / world.rs:293) on the SAME 12-layer pile at the SAME N
as scripts/cold_oracle.py, so the engine's rows-Jacobi cold quality and
the f64 sequential-GS oracle's quality (max_pen 0.073-0.081 at 2k,
steps 150-300) are compared at matched scale instead of across a 50x N
gap (2k oracle vs 100k bench row).

Usage: python scripts/cold_bridge.py [--bodies 2000] [--steps 300]
"""
import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: F401  (sets the compilation cache)
import jax
import numpy as np

from mgf_tpu.scenes import stress_scene
from mgf_tpu.world import step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--sample", type=int, default=30)
    args = ap.parse_args()

    w, cfg = stress_scene(args.bodies)
    cfg = cfg._replace(warm_start=False, fused_iso=False,
                       warm_match="search", adapt_schedule=None,
                       solver_iters=20, solver_inner=1, two_phase=True,
                       bp_every=1)
    w = w._replace(warm=None, bp=None)
    f = jax.jit(functools.partial(step, cfg=cfg))
    print(f"engine cold GS-schedule: {args.bodies} bodies, 20 two-phase "
          f"sweeps (rows-Jacobi)", flush=True)
    pens = []
    for s in range(args.steps):
        w, m = f(w)
        if (s + 1) % args.sample == 0:
            pen = float(np.asarray(m["max_penetration"]))
            nc = int(np.asarray(m["num_contacts"]))
            if s + 1 >= 150:
                pens.append(pen)
            print(f"step {s+1:4d}: max_pen={pen:.3f} contacts={nc}",
                  flush=True)
    print(f"\nRESULT bodies={args.bodies} settled(>=150) max_pen "
          f"range {min(pens):.3f}-{max(pens):.3f} "
          f"(oracle f64 cold-GS at 2k: 0.073-0.081)", flush=True)


if __name__ == "__main__":
    main()
