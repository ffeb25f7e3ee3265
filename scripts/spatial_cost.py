"""Spatial (multi-device) path cost accounting.

Runs the x-slab + halo-exchange spatial step on a virtual CPU mesh and
records (a) comm floats per step (the ppermute halo traffic the design
would put on the interconnect), (b) step wall-time vs the single-device step at the
same N, (c) the all-gather fallback's comm volume for contrast.

Virtual-CPU wall times do NOT model interconnect latency — the point is the
traffic accounting and the overhead structure (shape-rows, halo packing)
so the design has a cost model before real multi-chip hardware appears.

Run with:
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/spatial_cost.py [--bodies 16000] [--steps 20]
"""
import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# a virtual 8-device CPU mesh, like the test suite's
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import jax.numpy as jnp
import numpy as np


def timeit(f, w, steps):
    w2, m = f(w)
    jax.block_until_ready(w2)
    t0 = time.perf_counter()
    for _ in range(steps):
        w2, m = f(w2)
    jax.block_until_ready(w2)
    return (time.perf_counter() - t0) / steps * 1e3, m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=16000)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    from jax.sharding import Mesh
    from mgf_tpu.parallel import make_spatial_step, shard_world_spatial
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import step

    devs = jax.devices()
    print(f"{len(devs)} devices ({devs[0].platform})")
    world, cfg = stress_scene(args.bodies)

    # single-device reference
    ms1, _ = timeit(jax.jit(functools.partial(step, cfg=cfg)), world,
                    args.steps)
    print(f"single-device step: {ms1:.1f} ms at N={args.bodies}")

    mesh = Mesh(np.asarray(devs), ("b",))
    w_sp, bounds = shard_world_spatial(world, mesh, cfg=cfg)
    # halo capacity: bodies within halo_width (= cell) of a slab boundary;
    # a dense 12-layer pile puts ~N/D * (cell / slab_width) bodies there
    f_sp = make_spatial_step(cfg, mesh, bounds, halo=2048)
    ms8, m = timeit(f_sp, w_sp, args.steps)
    m = jax.tree_util.tree_map(np.asarray, m)
    comm = int(m.get("comm_floats_per_step", -1))
    print(f"spatial {len(devs)}-dev step: {ms8:.1f} ms "
          f"(x{ms8 / ms1:.2f} vs single)")
    print(f"comm floats/step (all shards): {comm} "
          f"({comm * 4 / 1e6:.2f} MB; per-shard "
          f"{comm * 4 / 1e6 / len(devs):.3f} MB)")
    print(f"stray={int(m.get('spatial_stray', -1))} "
          f"halo_overflow={int(m.get('halo_overflow', -1))} "
          f"contacts={int(m.get('num_contacts', -1))}")
    # per-solver-iteration halo velocity exchange dominates comm: scale
    # with solver schedule for the model
    print(f"solver schedule: {cfg.solver_iters} outer x "
          f"{cfg.solver_inner} inner")


if __name__ == "__main__":
    main()
