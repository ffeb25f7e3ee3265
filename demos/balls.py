"""Headless "balls" demo — the reference's mgf_demo/balls.rs scene.

11^3 + 1 spheres (r = 0.5, mass 1, restitution 0.3, friction 0.6) dropped
into the open-top box terrain, dt = 1/60, 20 solver iterations; prints
per-step wall-clock ms exactly like balls.rs:107-112 (no GL window — the
physics is the demo).

    python demos/balls.py [--steps 600] [--num 11] [--save out.npz]
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
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--num", type=int, default=11)
    ap.add_argument("--solver", default="rows",
                    choices=["rows", "parallel", "sequential"])
    ap.add_argument("--save", default=None,
                    help="save the trajectory (positions per frame) to .npz")
    ap.add_argument("--render", default=None,
                    help="render the final frame to a .ppm image")
    args = ap.parse_args()
    enable_compile_cache()

    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import make_step_fn
    from mgf_tpu.math3d import vto

    world, cfg = balls_scene(num=args.num, solver=args.solver)
    step = make_step_fn(cfg)
    print(f"balls: {world.bodies.n_bodies} spheres, dt=1/60, "
          f"{cfg.solver_iters} solver iters, solver={cfg.solver}")

    t0 = time.perf_counter()
    world, metrics = step(world)
    jax.block_until_ready(world)
    print(f"first step (compile): {time.perf_counter() - t0:.1f}s")

    frames = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        world, metrics = step(world)
        jax.block_until_ready(world)
        ms = (time.perf_counter() - t0) * 1000
        print(f"Physics step elapsed, took {ms:.2f} ms  "
              f"(contacts={int(metrics['num_contacts'])})", end="\r")
        if args.save:
            frames.append(np.asarray(vto(world.bodies.x)))
    print()
    y = np.asarray(world.bodies.x.y)
    print(f"done: y range [{y.min():.2f}, {y.max():.2f}]")
    if args.save:
        np.savez_compressed(args.save, x=np.stack(frames))
        print(f"saved trajectory to {args.save}")
    if args.render:
        from render import render_world
        render_world(world, path=args.render)
        print(f"rendered final frame to {args.render}")


if __name__ == "__main__":
    main()
