"""Mixed (sphere/capsule) contact-stream resync vs the f64 oracle with the
SHIPPED mixed semantics — cap_manifold="ends" (the
extension's contact stream had never been diffed against reference-
semantics f64 beyond two unit goldens).

Pattern: every step the oracle's f64 state is pushed into the f32 engine
step (collect_contacts=True) and both contact streams are diffed contact
for contact — capsule-terrain included (the box floor + walls).  Gates
mirror the r2 capsule resync (tests/test_oracle.py).

Usage: python scripts/mixed_resync.py [--bodies 2000] [--steps 120]
"""
import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from mgf_tpu import oracle
from mgf_tpu.scenes import stress_scene
from mgf_tpu.world import step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bodies", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--settle", type=int, default=150,
                    help="oracle-only pre-settle steps before the diff "
                         "window (contact-rich regime)")
    args = ap.parse_args()

    from test_oracle import _diff_streams  # the shared diff harness

    world, cfg = stress_scene(args.bodies, mixed=True, layers=6)
    assert cfg.cap_manifold == "ends"
    f = jax.jit(functools.partial(step, cfg=cfg, collect_contacts=True))
    ow = oracle.from_world(world)
    for s in range(args.settle):
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   cap_manifold="ends")
        if s % 50 == 0:
            print(f"settle {s}", flush=True)

    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    slot1_seen = 0
    cterr = 0
    stype = np.asarray(world.bodies.shape_type)
    for s in range(args.steps):
        w_in = oracle.to_world(ow, world)
        w, m = f(w_in)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                     cap_manifold="ends")
        slot1_seen += int(np.sum((np.asarray(rec["kind"]) == 1)
                                 & (np.asarray(rec["slot"]) == 1)))
        kind = np.asarray(rec["kind"])
        cterr += int(np.sum((kind == 0)
                            & (stype[np.asarray(rec["i"],
                                                np.int64)] == 1)))
        worst = _diff_streams(m, rec, worst)
        if s % 20 == 0:
            print(f"step {s}: total={worst['total']} miss={worst['miss']} "
                  f"dt={worst['dt']:.2e} dn={worst['dn']:.2e} "
                  f"dp={worst['dp']:.2e}", flush=True)

    print(f"\nRESULT bodies={args.bodies} steps={args.steps} "
          f"contacts_compared={worst['total']} miss={worst['miss']} "
          f"({100.0 * worst['miss'] / max(worst['total'], 1):.3f}%) "
          f"dt={worst['dt']:.2e} dn={worst['dn']:.2e} dp={worst['dp']:.2e} "
          f"ends_slot1={slot1_seen} capsule_terrain={cterr}")


if __name__ == "__main__":
    main()
