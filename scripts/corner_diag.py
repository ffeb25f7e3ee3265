"""Dissect the deepest capsule-terrain contacts of a settled mixed stress
checkpoint ON CPU (no re-settle): recompute the near-terrain cull in
numpy, run the engine's f32 triangle x capsule narrowphase AND the f64
oracle's on the worst bodies, and report witness geometry, per-face
candidate sets, velocities, and engine-vs-f64 penetration — connecting
the 100k max-pen to a mechanism.

Usage: python scripts/settle_save.py /tmp/mixed100k.npz --mixed
       JAX_PLATFORMS=cpu python scripts/corner_diag.py /tmp/mixed100k.npz
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu import oracle
from mgf_tpu.collision import contact_neg, contact_triangle_moving_capsule
from mgf_tpu.geom import Capsule, Triangle
from mgf_tpu.math3d import Vec3
from mgf_tpu.physics import capsule_axis
from mgf_tpu.scenes import stress_scene
from mgf_tpu.utils.checkpoint import load_world


def v3np(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)],
                    axis=-1).astype(np.float64)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--bodies", type=int, default=100_000)
    ap.add_argument("--top", type=int, default=24)
    args = ap.parse_args()

    like, cfg = stress_scene(args.bodies, mixed=True)
    w = load_world(args.ckpt, like)
    st = w.bodies
    x = v3np(st.x)
    delta = v3np(st.delta)
    vel = v3np(st.v)
    stype = np.asarray(st.shape_type)
    r = np.asarray(st.shape_r, np.float64)
    hh = np.asarray(st.shape_half_h, np.float64)

    ta, tb, tc = v3np(w.terrain.a), v3np(w.terrain.b), v3np(w.terrain.c)
    tlo = np.minimum(np.minimum(ta, tb), tc)    # (T, 3)
    thi = np.maximum(np.maximum(ta, tb), tc)

    # the engine's near cull (world.py "near"): point-to-face-AABB distance
    d_ax = np.maximum(np.maximum(tlo[None] - x[:, None], x[:, None]
                                 - thi[None]), 0.0)
    d2 = np.einsum("ntk,ntk->nt", d_ax, d_ax)
    reach = r + hh + np.linalg.norm(delta, axis=-1) + 0.1
    score = np.where(d2 <= (reach ** 2)[:, None], -d2, -np.inf)
    C = cfg.terrain_cand
    pick = np.argsort(-score, axis=1, kind="stable")[:, :C]   # top-C faces
    ok = np.take_along_axis(np.isfinite(score), pick, axis=1)

    caps = np.where(stype == 1)[0]
    print(f"{len(caps)} capsules; cull C={C}")

    # engine f32 narrowphase on ALL capsule (body, cand) pairs
    dh = v3np(capsule_axis(st))
    ca_np = x - dh
    cd_np = 2.0 * dh
    idx = caps
    trip = pick[idx]                                   # (M, C)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    mkv = lambda a: Vec3(f32(a[..., 0]), f32(a[..., 1]), f32(a[..., 2]))
    tri = Triangle(a=mkv(ta[trip]), b=mkv(tb[trip]), c=mkv(tc[trip]))
    cap = Capsule(a=mkv(ca_np[idx][:, None].repeat(C, 1)),
                  d=mkv(cd_np[idx][:, None].repeat(C, 1)),
                  r=f32(np.repeat(r[idx][:, None], C, 1)))
    vsw = mkv(delta[idx][:, None].repeat(C, 1))
    out = jax.jit(lambda t, c, v: contact_neg(
        contact_triangle_moving_capsule(t, c, v)))(tri, cap, vsw)
    a_e, b_e, n_e = v3np(out.a), v3np(out.b), v3np(out.n)
    val = np.asarray(out.valid)
    pen_e = np.where(val, np.maximum(
        -np.sum((b_e - a_e) * n_e, axis=-1), 0.0), 0.0)

    worst_per_body = pen_e.max(axis=(0, 2))           # (M,)
    order = np.argsort(-worst_per_body)[:args.top]
    print("\nworst capsule-terrain bodies (engine f32, settled state):")
    for m in order:
        bid = int(idx[m])
        s, c = np.unravel_index(np.argmax(pen_e[:, m, :]),
                                (pen_e.shape[0], C))
        face = int(trip[m, c])
        # f64 oracle on the same (body, face) pair (batch of 1)
        o = oracle.contact_triangle_moving_capsule_np(
            ta[face][None], tb[face][None], tc[face][None],
            ca_np[bid][None], cd_np[bid][None], np.r_[r[bid]],
            delta[bid][None])
        op = []
        for sl in range(2):
            oa, ob, on, ot, ov = [np.asarray(z) for z in o[sl]]
            if bool(np.all(ov)):
                # contact_neg convention (body side a): flipped pen =
                # -((a - b) . -n)
                p = max(float(-np.sum((oa[0] - ob[0]) * (-on[0]))), 0.0)
                op.append(f"s{sl} pen={p:.3f} n=({-on[0,0]:.2f},"
                          f"{-on[0,1]:.2f},{-on[0,2]:.2f}) "
                          f"t={float(ot[0]):.3f}")
        print(f"body {bid} pos=({x[bid,0]:.2f},{x[bid,1]:.2f},{x[bid,2]:.2f})"
              f" |v|={np.linalg.norm(vel[bid]):.2f}"
              f" |dx|={np.linalg.norm(delta[bid]):.3f}"
              f" faces={[int(t) for t in trip[m]]} ok={ok[idx][m].tolist()}")
        print(f"   engine: face {face} slot {s} pen={pen_e[s, m, c]:.3f} "
              f"n=({n_e[s, m, c, 0]:.2f},{n_e[s, m, c, 1]:.2f},"
              f"{n_e[s, m, c, 2]:.2f}) t={float(np.asarray(out.t)[s, m, c]):.3f} "
              f"a=({a_e[s, m, c, 0]:.2f},{a_e[s, m, c, 1]:.2f},"
              f"{a_e[s, m, c, 2]:.2f})")
        print(f"   oracle f64 same pair: {' | '.join(op) if op else 'no contact'}")


if __name__ == "__main__":
    main()
