"""What does the REFERENCE's own cold 20-sweep Gauss-Seidel yield on the
12-layer stress pile? 

The reference zeroes accumulators every frame and runs 20 sequential GS
sweeps (solver.rs:72-78, world.rs:293).  Our warm-start extension is a
documented divergence; this script establishes the reference-semantics
quality bar by running the f64 oracle (numpy narrowphase + C++ f64
sequential GS, reference constraint order) on the same pile that the
100k stress scene uses, at oracle-tractable N.

Prints max penetration / contact count every sample interval.

Usage: python scripts/cold_oracle.py [--bodies 2000] [--steps 420]
       [--iters 20] [--textbook]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def pen_of(records):
    """Deepest contact penetration: dot(b - a, n) < 0 when overlapping
    (solver.rs:140 sign convention; matches world.step's metric)."""
    if len(records["t"]) == 0:
        return 0.0
    pen = np.einsum("ij,ij->i", records["pb"] - records["pa"],
                    records["n"])
    return float(np.maximum(-pen, 0.0).max()) if len(pen) else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=420)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sample", type=int, default=30)
    ap.add_argument("--mixed", action="store_true",
                    help="25%% capsule mix (the stress mixed scene) — "
                         "ground truth for the mixed pile's settled "
                         "agitation level under reference semantics")
    ap.add_argument("--textbook", action="store_true",
                    help="textbook clamped friction instead of the "
                         "reference's raw-lambda quirk")
    args = ap.parse_args()

    from mgf_tpu.oracle import from_world, oracle_step
    from mgf_tpu.scenes import stress_scene

    world, _ = stress_scene(args.bodies, mixed=args.mixed)
    ow = from_world(world)
    print(f"oracle cold GS: {args.bodies} bodies, {args.iters} sweeps, "
          f"mgf_friction={not args.textbook}", flush=True)
    t0 = time.perf_counter()
    for s in range(args.steps):
        ow, rec = oracle_step(ow, dt=1.0 / 60.0, iters=args.iters,
                              mgf_friction=not args.textbook)
        if (s + 1) % args.sample == 0:
            nc = len(rec["t"])
            vn = np.linalg.norm(ow.v, axis=-1)
            print(f"step {s+1:4d}: max_pen={pen_of(rec):.3f} "
                  f"contacts={nc} "
                  f"v_max={vn.max():.3f} v_mean={vn.mean():.3f} "
                  f"({(time.perf_counter()-t0)/(s+1):.2f} s/step)",
                  flush=True)
    print("done", flush=True)


if __name__ == "__main__":
    main()
