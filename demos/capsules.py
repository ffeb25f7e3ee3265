"""Headless "capsules" demo — the reference's mgf_demo/capsules.rs scene.

11^3 capsules (a=(-0.5,0,0), d=(1,0,0), r=1) on the box terrain,
dt = 1/60, 20 solver iterations; per-step wall-clock print per
capsules.rs:106-111.

    python demos/capsules.py [--steps 300] [--num 11]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from mgf_tpu.utils.runtime import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--num", type=int, default=11)
    ap.add_argument("--render", default=None,
                    help="render the final frame to a .ppm image")
    args = ap.parse_args()
    enable_compile_cache()

    from mgf_tpu.scenes import capsules_scene
    from mgf_tpu.world import make_step_fn

    world, cfg = capsules_scene(num=args.num)
    step = make_step_fn(cfg)
    print(f"capsules: {world.bodies.n_bodies} capsules, dt=1/60, "
          f"{cfg.solver_iters} solver iters")

    t0 = time.perf_counter()
    world, metrics = step(world)
    jax.block_until_ready(world)
    print(f"first step (compile): {time.perf_counter() - t0:.1f}s")

    for i in range(args.steps):
        t0 = time.perf_counter()
        world, metrics = step(world)
        jax.block_until_ready(world)
        ms = (time.perf_counter() - t0) * 1000
        print(f"Physics step elapsed, took {ms:.2f} ms  "
              f"(contacts={int(metrics['num_contacts'])})", end="\r")
    print()
    y = np.asarray(world.bodies.x.y)
    print(f"done: y range [{y.min():.2f}, {y.max():.2f}]")
    if args.render:
        from render import render_world
        render_world(world, path=args.render)
        print(f"rendered final frame to {args.render}")


if __name__ == "__main__":
    main()
