"""Constraint-based contact solver.

Counterpart of ``src/solver.rs``: warm-started sequential impulses
with Baumgarte stabilization, restitution threshold, and two-axis friction
(ContactConstraint, solver.rs:82-253), in Vec3 component form.

Two execution modes share the same per-point impulse math:

* ``solve_sequential`` — a ``lax.scan`` over contact points inside each
  iteration; reproduces mgf's Gauss-Seidel ordering exactly (solver.rs:72-78)
  and is the parity path for tests / small scenes.
* ``solve_parallel`` — a Jacobi sweep with *mass splitting* (per-body inverse
  masses scaled by the body's contact count inside the effective-mass
  denominators; Tonge et al. 2012).  All contact points are solved
  concurrently; velocity deltas are reduced with per-component segment sums.

Friction-clamp policy: mgf's accumulator clamp is broken — solver.rs:226
passes arguments to ``clamp`` in the wrong order and solver.rs:227 applies
the *raw* lambda rather than the clamped delta, so reference friction acts
unclamped.  The default here is the textbook clamped accumulator;
``friction_mode="mgf"`` reproduces the raw-lambda behavior.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mgf_tpu.manifold import Manifold
from mgf_tpu.math3d import (
    Mat3, Vec3, cross, dot, magnitude2, mat_vec, safe_div,
)

# DefaultContactConstraintParams (solver.rs:276-279)
PENETRATION_SLOP = 0.05
BAUMGARTE = 0.2


def contact_bias(pen, rel_v, restitution, dt, bias_max: float = -1.0):
    """Baumgarte + restitution bias velocity (solver.rs:145-153).

    ``bias_max`` >= 0 clamps the POSITION-correction (Baumgarte) term —
    a documented stability EXTENSION (off by default = reference
    semantics): Baumgarte converts penetration into REAL outgoing
    velocity (beta/dt = 12x pen at dt=1/60), so a deeply loaded contact
    (capsule piles rock to ~0.3) is ejected at up to ~3 m/s, which then
    re-triggers the restitution threshold on its neighbors — a measured
    self-sustaining agitation loop at 100k mixed (escaped bodies,
    settled |v| ~ 2-6).  The restitution term is never clamped."""
    b = -BAUMGARTE / dt * jnp.where(pen > 0.0, 0.0,
                                    pen + PENETRATION_SLOP)
    if bias_max >= 0.0:
        b = jnp.minimum(b, bias_max)
    return b + jnp.where(rel_v < -1.0, -restitution * rel_v, 0.0)


class BodyView(NamedTuple):
    """Per-body quantities the solver reads (ConstrainedSet get,
    physics.rs:272-304).  Rows with inv_mass = 0, inv_moment = 0,
    restitution = 0 behave exactly like RigidBodyRef::Static.
    ``x`` must be the end-of-sweep position (x + delta, physics.rs:282)."""
    x: Vec3
    v: Vec3
    omega: Vec3
    restitution: jnp.ndarray
    friction: jnp.ndarray
    inv_mass: jnp.ndarray
    inv_moment: Mat3


class ContactConstraints(NamedTuple):
    """Flat SoA of contact points ready to solve (ContactState,
    solver.rs:256-262, plus indices/geometry)."""
    body_a: jnp.ndarray    # (C,) int32
    body_b: jnp.ndarray    # (C,) int32
    ra: Vec3               # contact point local to body a
    rb: Vec3
    normal: Vec3
    t1: Vec3               # friction tangents
    t2: Vec3
    friction: jnp.ndarray  # mixed sqrt(fa*fb) (solver.rs:126)
    bias: jnp.ndarray
    normal_mass: jnp.ndarray
    tangent_mass1: jnp.ndarray
    tangent_mass2: jnp.ndarray
    valid: jnp.ndarray     # bool


def build_constraints(bodies: BodyView, body_a, body_b, manifold: Manifold,
                      dt, split_a=None, split_b=None,
                      bias_max: float = -1.0) -> ContactConstraints:
    """Precompute per-contact state (ContactConstraint::new,
    solver.rs:101-192), vectorized over a pair batch.

    ``manifold`` fields have batch shape (P,) with leading slot axis S; the
    result is flattened to C = S*P points.  ``split_a``/``split_b`` are
    optional (P,) mass-splitting factors for the parallel solver; omit for
    exact reference effective masses.
    """
    S = manifold.valid.shape[0]

    xa, xb = bodies.x[body_a], bodies.x[body_b]
    va, vb = bodies.v[body_a], bodies.v[body_b]
    oa, ob = bodies.omega[body_a], bodies.omega[body_b]
    ima, imb = bodies.inv_mass[body_a], bodies.inv_mass[body_b]
    Ia, Ib = bodies.inv_moment[body_a], bodies.inv_moment[body_b]
    restitution = jnp.maximum(bodies.restitution[body_a],
                              bodies.restitution[body_b])
    friction = jnp.sqrt(bodies.friction[body_a] * bodies.friction[body_b])

    if split_a is None:
        split_a = jnp.ones_like(ima)
    if split_b is None:
        split_b = jnp.ones_like(imb)
    ima_s = ima * split_a
    imb_s = imb * split_b
    Ia_s = Ia * split_a
    Ib_s = Ib * split_b

    n = manifold.normal
    t1 = manifold.t1
    t2 = manifold.t2

    def per_slot(s):
        ra = manifold.local_a[s]
        rb = manifold.local_b[s]
        ra_cn = cross(ra, n)
        rb_cn = cross(rb, n)
        pen = dot((rb + xb) - (ra + xa), n)
        dv = vb + cross(ob, rb) - va - cross(oa, ra)
        rel_v = dot(dv, n)
        bias = contact_bias(pen, rel_v, restitution, dt, bias_max)
        normal_mass = safe_div(
            1.0, ima_s + dot(ra_cn, mat_vec(Ia_s, ra_cn))
            + imb_s + dot(rb_cn, mat_vec(Ib_s, rb_cn)))

        def tm(t):
            ra_ct = cross(ra, t)
            rb_ct = cross(rb, t)
            return safe_div(
                1.0, ima_s + dot(ra_ct, mat_vec(Ia_s, ra_ct))
                + imb_s + dot(rb_ct, mat_vec(Ib_s, rb_ct)))

        return ra, rb, bias, normal_mass, tm(t1), tm(t2)

    slots = [per_slot(s) for s in range(S)]

    def cat(i):
        vals = [sl[i] for sl in slots]
        return jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *vals)

    rep = lambda a: jax.tree_util.tree_map(
        lambda x: jnp.concatenate([x] * S, axis=0), a)

    return ContactConstraints(
        body_a=rep(body_a.astype(jnp.int32)),
        body_b=rep(body_b.astype(jnp.int32)),
        ra=cat(0), rb=cat(1),
        normal=rep(n), t1=rep(t1), t2=rep(t2),
        friction=rep(friction),
        bias=cat(2), normal_mass=cat(3),
        tangent_mass1=cat(4), tangent_mass2=cat(5),
        valid=manifold.valid.reshape(-1),
    )


def _friction_impulses(con, dv: Vec3, acc_t1, acc_t2, friction_mode, acc_n):
    """Both tangent-axis lambdas from a single dv (solver.rs:220-232).
    Returns (applied1, applied2, new_acc1, new_acc2)."""
    lam1 = -dot(dv, con.t1) * con.tangent_mass1
    lam2 = -dot(dv, con.t2) * con.tangent_mass2
    if friction_mode == "mgf":
        # reference applies the raw lambda each sweep (broken clamp)
        return lam1, lam2, acc_t1 + lam1, acc_t2 + lam2
    max_l = con.friction * acc_n
    new1 = jnp.clip(acc_t1 + lam1, -max_l, max_l)
    new2 = jnp.clip(acc_t2 + lam2, -max_l, max_l)
    return new1 - acc_t1, new2 - acc_t2, new1, new2


def _normal_impulse(con, dv: Vec3, acc_n):
    """Projected normal impulse (solver.rs:236-240)."""
    vn = dot(dv, con.normal)
    lam = con.normal_mass * (-vn + con.bias)
    new_acc = jnp.maximum(acc_n + lam, 0.0)
    return new_acc - acc_n, new_acc


def solve_sequential(con: ContactConstraints, bodies: BodyView, iters: int,
                     friction_mode: str = "textbook"):
    """Gauss-Seidel sweeps in point order — reference-exact semantics.
    O(iters * C) sequential steps: tests / small scenes only."""
    C = con.body_a.shape[0]
    inv_mass, inv_moment = bodies.inv_mass, bodies.inv_moment

    def vset(v: Vec3, i, val: Vec3, keep) -> Vec3:
        return Vec3(v.x.at[i].set(jnp.where(keep, val.x, v.x[i])),
                    v.y.at[i].set(jnp.where(keep, val.y, v.y[i])),
                    v.z.at[i].set(jnp.where(keep, val.z, v.z[i])))

    def point(carry, i):
        v, omega, acc_n, acc_t1, acc_t2 = carry
        a = con.body_a[i]
        b = con.body_b[i]
        ok = con.valid[i]
        ci = jax.tree_util.tree_map(lambda x: x[i], con)
        va, vb = v[a], v[b]
        oa, ob = omega[a], omega[b]
        ima, imb = inv_mass[a], inv_mass[b]
        Ia, Ib = inv_moment[a], inv_moment[b]

        dv = vb + cross(ob, ci.rb) - va - cross(oa, ci.ra)
        f1, f2, a_t1, a_t2 = _friction_impulses(ci, dv, acc_t1[i], acc_t2[i],
                                                friction_mode, acc_n[i])
        imp = ci.t1 * f1 + ci.t2 * f2
        va = va - imp * ima
        oa = oa - mat_vec(Ia, cross(ci.ra, imp))
        vb = vb + imp * imb
        ob = ob + mat_vec(Ib, cross(ci.rb, imp))

        dv = vb + cross(ob, ci.rb) - va - cross(oa, ci.ra)
        fn, a_n = _normal_impulse(ci, dv, acc_n[i])
        imp = ci.normal * fn
        va = va - imp * ima
        oa = oa - mat_vec(Ia, cross(ci.ra, imp))
        vb = vb + imp * imb
        ob = ob + mat_vec(Ib, cross(ci.rb, imp))

        v = vset(vset(v, a, va, ok), b, vb, ok)
        omega = vset(vset(omega, a, oa, ok), b, ob, ok)
        acc_n = acc_n.at[i].set(jnp.where(ok, a_n, acc_n[i]))
        acc_t1 = acc_t1.at[i].set(jnp.where(ok, a_t1, acc_t1[i]))
        acc_t2 = acc_t2.at[i].set(jnp.where(ok, a_t2, acc_t2[i]))
        return (v, omega, acc_n, acc_t1, acc_t2), None

    def sweep(carry, _):
        carry, _ = jax.lax.scan(point, carry, jnp.arange(C))
        return carry, None

    zero = jnp.zeros((C,), jnp.float32)
    init = (bodies.v, bodies.omega, zero, zero, zero)
    (v, omega, _, _, _), _ = jax.lax.scan(sweep, init, None, length=iters)
    return v, omega


def contact_counts(valid, body_a, body_b, num_bodies: int):
    """Number of valid contact points touching each body (mass splitting)."""
    ones = valid.astype(jnp.float32)
    ca = jax.ops.segment_sum(ones, body_a, num_segments=num_bodies)
    cb = jax.ops.segment_sum(ones, body_b, num_segments=num_bodies)
    return jnp.maximum(ca + cb, 1.0)


def _seg_vec(v: Vec3, ids, m) -> Vec3:
    return Vec3(jax.ops.segment_sum(v.x, ids, num_segments=m),
                jax.ops.segment_sum(v.y, ids, num_segments=m),
                jax.ops.segment_sum(v.z, ids, num_segments=m))


def solve_parallel(con: ContactConstraints, bodies: BodyView, iters: int,
                   friction_mode: str = "textbook"):
    """Mass-split Jacobi sweeps — fully parallel over contact points.

    ``con`` must be built with split factors = contact counts for
    convergence.  Each iteration: a friction phase and a normal phase, each a
    gather -> impulse -> per-component segment-sum scatter.
    """
    M = bodies.inv_mass.shape[0]
    inv_mass, inv_moment = bodies.inv_mass, bodies.inv_moment
    okf = con.valid.astype(jnp.float32)

    def apply_impulse(v, omega, imp: Vec3):
        imp = imp * okf
        dv = (_seg_vec(-imp, con.body_a, M) + _seg_vec(imp, con.body_b, M))
        v = v + dv * inv_mass
        dl = (_seg_vec(-cross(con.ra, imp), con.body_a, M)
              + _seg_vec(cross(con.rb, imp), con.body_b, M))
        omega = omega + mat_vec(inv_moment, dl)
        return v, omega

    def rel_vel(v, omega):
        va, vb = v[con.body_a], v[con.body_b]
        oa, ob = omega[con.body_a], omega[con.body_b]
        return (vb + cross(ob, con.rb)) - (va + cross(oa, con.ra))

    def sweep(carry, _):
        v, omega, acc_n, acc_t1, acc_t2 = carry
        dv = rel_vel(v, omega)
        f1, f2, acc_t1, acc_t2 = _friction_impulses(con, dv, acc_t1, acc_t2,
                                                    friction_mode, acc_n)
        v, omega = apply_impulse(v, omega, con.t1 * f1 + con.t2 * f2)

        dv = rel_vel(v, omega)
        fn, acc_n = _normal_impulse(con, dv, acc_n)
        v, omega = apply_impulse(v, omega, con.normal * fn)
        return (v, omega, acc_n, acc_t1, acc_t2), None

    C = con.body_a.shape[0]
    zero = jnp.zeros((C,), jnp.float32)
    init = (bodies.v, bodies.omega, zero, zero, zero)
    (v, omega, _, _, _), _ = jax.lax.scan(sweep, init, None, length=iters)
    return v, omega


# ---------------------------------------------------------------------------
# Row-structured scatter-free parallel solver
# ---------------------------------------------------------------------------
#
# The flat ContactConstraints form above needs per-iteration gathers by
# body_a/body_b AND segment-sum scatters, and the scatters dominate the
# step.  The row form eliminates them: every body owns a row of
# R constraint slots (its broadphase partners + terrain triangles), each pair
# appears TWICE (once per body, mirrored), and a solver iteration is
#
#     one gather of the packed (8, M) body state by the (R, N) partner
#     matrix + elementwise impulse math + a sum over the R axis
#
# — no scatter at all.  The twin copies of a pair compute bit-identical
# impulses from the same global state, so both sides receive consistent
# updates; with mass splitting (counts in the effective masses) the
# iteration converges like the flat Jacobi.  On the engine's first
# accelerator this was far faster than the segment-sum formulation (not
# measured on the H100).

class RowConstraints(NamedTuple):
    """Per-body rows of contact-point slots; all arrays (R, N) (slot-major so
    the body axis N is the contiguous minor dimension)."""
    partner: jnp.ndarray   # (R, N) int32 partner body (N_static for terrain)
    ra: Vec3               # contact point local to the row body
    rb: Vec3               # contact point local to the partner
    normal: Vec3
    t1: Vec3
    t2: Vec3
    friction: jnp.ndarray
    bias: jnp.ndarray
    normal_mass: jnp.ndarray
    tangent_mass1: jnp.ndarray
    tangent_mass2: jnp.ndarray
    valid: jnp.ndarray     # (R, N) bool


def pack_solver_bodies(bodies: BodyView, counts=None):
    """Pack the per-body quantities the constraint precompute reads into
    three (M, 8) tables so the (R, N)-indexed reads are 3 wide gathers
    instead of ~21 scalar ones (gather cost is per index).

    A: x.xyz  v.xyz  restitution friction
    B: omega.xyz  inv_mass  count  _ _ _
    C: inverse inertia (symmetric): Ixx Ixy Ixz Iyy Iyz Izz _ _
    """
    z = jnp.zeros_like(bodies.inv_mass)
    cnt = counts if counts is not None else jnp.ones_like(bodies.inv_mass)
    A = jnp.stack([bodies.x.x, bodies.x.y, bodies.x.z,
                   bodies.v.x, bodies.v.y, bodies.v.z,
                   bodies.restitution, bodies.friction], axis=-1)
    B = jnp.stack([bodies.omega.x, bodies.omega.y, bodies.omega.z,
                   bodies.inv_mass, cnt, z, z, z], axis=-1)
    I = bodies.inv_moment
    C = jnp.stack([I.xx, I.xy, I.xz, I.yy, I.yz, I.zz, z, z], axis=-1)
    return A, B, C


def _unpack_solver_rows(A, B, C, idx):
    a = A[idx]
    b = B[idx]
    c = C[idx]
    x = Vec3(a[..., 0], a[..., 1], a[..., 2])
    v = Vec3(a[..., 3], a[..., 4], a[..., 5])
    restitution = a[..., 6]
    friction = a[..., 7]
    omega = Vec3(b[..., 0], b[..., 1], b[..., 2])
    inv_mass = b[..., 3]
    count = b[..., 4]
    I = Mat3(c[..., 0], c[..., 1], c[..., 2],
             c[..., 1], c[..., 3], c[..., 4],
             c[..., 2], c[..., 4], c[..., 5])
    return x, v, omega, restitution, friction, inv_mass, count, I


def build_row_constraints(bodies: BodyView, partner, manifold: Manifold,
                          dt, counts=None, self_rows=None,
                          col_offset: int = 0,
                          bias_max: float = -1.0) -> RowConstraints:
    """Precompute per-slot state for the row solver.

    ``partner`` is (R, N) int32; ``manifold`` fields are already shaped
    (R, N) (single slot axis).  ``counts`` (M,) enables mass splitting.
    ``self_rows`` (N,) gives the global body index of each column (defaults
    to ``col_offset .. col_offset + N``); the self side is read with
    broadcasts, not gathers.
    """
    n = partner.shape[1]
    lo, hi = col_offset, col_offset + n
    A, B, C = pack_solver_bodies(bodies, counts)

    if self_rows is None:
        # self side: plain slices broadcast over the slot axis — no gather
        sl = lambda t: jax.tree_util.tree_map(lambda g: g[lo:hi][None, :],
                                              t)
        xa = sl(bodies.x)
        va, oa = sl(bodies.v), sl(bodies.omega)
        ima = bodies.inv_mass[lo:hi][None, :]
        Ia = sl(bodies.inv_moment)
        ra_ = bodies.restitution[lo:hi][None, :]
        fa = bodies.friction[lo:hi][None, :]
        sa = (counts[lo:hi][None, :] if counts is not None else 1.0)
    else:
        (xa, va, oa, ra_, fa, ima, sa, Ia) = _unpack_solver_rows(
            A, B, C, self_rows[None, :])

    (xb, vb, ob, rb_, fb, imb, sb, Ib) = _unpack_solver_rows(A, B, C,
                                                             partner)

    restitution = jnp.maximum(ra_, rb_)
    friction = jnp.sqrt(fa * fb)

    if counts is not None:
        ima = ima * sa
        imb = imb * sb
        Ia = Ia * sa
        Ib = Ib * sb

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    ra_cn = cross(ra, nrm)
    rb_cn = cross(rb, nrm)
    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)
    normal_mass = safe_div(
        1.0, ima + dot(ra_cn, mat_vec(Ia, ra_cn))
        + imb + dot(rb_cn, mat_vec(Ib, rb_cn)))

    def tm(t):
        ra_ct = cross(ra, t)
        rb_ct = cross(rb, t)
        return safe_div(
            1.0, ima + dot(ra_ct, mat_vec(Ia, ra_ct))
            + imb + dot(rb_ct, mat_vec(Ib, rb_ct)))

    return RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=normal_mass,
        tangent_mass1=tm(t1), tangent_mass2=tm(t2), valid=manifold.valid)


def pack_solver_bodies_iso(bodies: BodyView, counts, iso_inv_moment):
    """One (M, 16) table for the ISOTROPIC-inertia constraint precompute
    (spheres: the world inverse inertia is a scalar per body, so the
    partner side needs a single 16-wide gather instead of three 8-wide
    ones, and every mat_vec collapses to a scalar multiply):

    x.xyz v.xyz omega.xyz restitution friction inv_mass count i_iso _ _
    """
    z = jnp.zeros_like(bodies.inv_mass)
    cnt = counts if counts is not None else jnp.ones_like(bodies.inv_mass)
    return jnp.stack([
        bodies.x.x, bodies.x.y, bodies.x.z,
        bodies.v.x, bodies.v.y, bodies.v.z,
        bodies.omega.x, bodies.omega.y, bodies.omega.z,
        bodies.restitution, bodies.friction, bodies.inv_mass, cnt,
        iso_inv_moment, z, z], axis=-1)


def build_row_constraints_iso(bodies: BodyView, partner, manifold: Manifold,
                              dt, counts=None,
                              bias_max: float = -1.0) -> RowConstraints:
    """Scalar-inertia build_row_constraints (spheres mode): identical
    physics to the Mat3 path when inv_moment == i * I3, at a third of the
    gather and arithmetic cost."""
    n = partner.shape[1]
    iso = bodies.inv_moment.xx          # (M,) — diag isotropic by contract
    tbl = pack_solver_bodies_iso(bodies, counts, iso)

    sl = lambda t: jax.tree_util.tree_map(lambda g: g[:n][None, :], t)
    xa = sl(bodies.x)
    va, oa = sl(bodies.v), sl(bodies.omega)
    ima = bodies.inv_mass[:n][None, :]
    ia = iso[:n][None, :]
    ra_ = bodies.restitution[:n][None, :]
    fa = bodies.friction[:n][None, :]
    sa = (counts[:n][None, :] if counts is not None else 1.0)

    g = tbl[partner]                     # (R, N, 16): ONE gather
    xb = Vec3(g[..., 0], g[..., 1], g[..., 2])
    vb = Vec3(g[..., 3], g[..., 4], g[..., 5])
    ob = Vec3(g[..., 6], g[..., 7], g[..., 8])
    rb_ = g[..., 9]
    fb = g[..., 10]
    imb = g[..., 11]
    sb = g[..., 12]
    ib = g[..., 13]
    # partner term for the solver's first sweep — rides for free on this
    # gather (the solver would otherwise re-fetch the same initial state)
    partner_term0 = vb + cross(ob, manifold.local_b)

    restitution = jnp.maximum(ra_, rb_)
    friction = jnp.sqrt(fa * fb)
    if counts is not None:
        ima = ima * sa
        imb = imb * sb
        ia = ia * sa
        ib = ib * sb

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)

    def eff_mass(axis):
        return safe_div(
            1.0, ima + ia * magnitude2(cross(ra, axis))
            + imb + ib * magnitude2(cross(rb, axis)))

    rc = RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=eff_mass(nrm),
        tangent_mass1=eff_mass(t1), tangent_mass2=eff_mass(t2),
        valid=manifold.valid)
    return rc, partner_term0


class PartnerFields(NamedTuple):
    """Pre-gathered partner-side quantities for the fused iso constraint
    build: ONE wide row gather at narrowphase time serves both the contact
    test and the constraint precompute (gather cost is per index, and
    a wide row rides at little more than a narrow one's cost).
    All arrays (K, N) where K is the pair-row count."""
    x_end: Vec3            # partner position at end of sweep (x + delta)
    v: Vec3
    omega: Vec3
    restitution: jnp.ndarray
    friction: jnp.ndarray
    inv_mass: jnp.ndarray
    count: jnp.ndarray     # mass-splitting contact count (clamped >= 1)
    iso: jnp.ndarray       # isotropic world inverse inertia scalar


def build_row_constraints_iso_fused(bodies: BodyView, counts,
                                    pf: PartnerFields, partner,
                                    manifold: Manifold, dt,
                                    static_x: Vec3,
                                    n_pair_rows: int,
                                    bias_max: float = -1.0) -> RowConstraints:
    """Gather-free iso constraint precompute.

    Identical physics to :func:`build_row_constraints_iso` given the same
    inputs, but with the partner-side quantities supplied by the caller:

    * rows ``[:n_pair_rows]`` read ``pf`` (pre-gathered at narrowphase
      time — the fetch is fused with the pair contact test);
    * rows ``[n_pair_rows:]`` have the static terrain body as partner —
      zero inverse mass/inertia/velocity, position ``static_x``, zero
      friction and restitution (``RigidBodyRef::Static``,
      physics.rs:289-302 + world.rs:247) — so no gather is needed at all.

    ``bodies`` covers the first N rows only (no static row) with ``x`` at
    end-of-sweep; ``counts`` is the (N,) mass-splitting contact count
    (callers using cross-frame warm state pass the PREVIOUS frame's counts,
    a documented approximation that avoids serializing the count behind
    this frame's narrowphase).
    """
    n = partner.shape[1]
    T = partner.shape[0] - n_pair_rows
    iso = bodies.inv_moment.xx

    zt = jnp.zeros((T, n), jnp.float32)
    cat = lambda p, t_: jnp.concatenate([p, t_], axis=0)
    catv = lambda p, t_: Vec3(cat(p.x, t_.x), cat(p.y, t_.y),
                              cat(p.z, t_.z))
    zvt = Vec3(zt, zt, zt)

    xb = catv(pf.x_end, Vec3(zt + static_x.x, zt + static_x.y,
                             zt + static_x.z))
    vb = catv(pf.v, zvt)
    ob = catv(pf.omega, zvt)
    rb_ = cat(pf.restitution, zt)
    fb = cat(pf.friction, zt)
    imb = cat(pf.inv_mass * pf.count, zt)   # pre-split by partner count
    ib = cat(pf.iso * pf.count, zt)

    # self side: broadcasts, no gather
    sl = lambda g: g[None, :]
    xa = jax.tree_util.tree_map(sl, bodies.x)
    va = jax.tree_util.tree_map(sl, bodies.v)
    oa = jax.tree_util.tree_map(sl, bodies.omega)
    ima = (bodies.inv_mass * counts)[None, :]
    ia = (iso * counts)[None, :]
    ra_ = bodies.restitution[None, :]
    fa = bodies.friction[None, :]

    restitution = jnp.maximum(ra_, rb_)
    friction = jnp.sqrt(fa * fb)

    ra = manifold.local_a
    rb = manifold.local_b
    nrm = manifold.normal
    t1, t2 = manifold.t1, manifold.t2

    pen = dot((rb + xb) - (ra + xa), nrm)
    dv = vb + cross(ob, rb) - va - cross(oa, ra)
    rel_v = dot(dv, nrm)
    bias = contact_bias(pen, rel_v, restitution, dt, bias_max)

    def eff_mass(axis):
        return safe_div(
            1.0, ima + ia * magnitude2(cross(ra, axis))
            + imb + ib * magnitude2(cross(rb, axis)))

    return RowConstraints(
        partner=partner, ra=ra, rb=rb, normal=nrm, t1=t1, t2=t2,
        friction=friction, bias=bias, normal_mass=eff_mass(nrm),
        tangent_mass1=eff_mass(t1), tangent_mass2=eff_mass(t2),
        valid=manifold.valid)


def pack_body_state(v: Vec3, omega: Vec3):
    """(8, M) packed dynamic state: rows vx vy vz ox oy oz pad pad."""
    z = jnp.zeros_like(v.x)
    return jnp.stack([v.x, v.y, v.z, omega.x, omega.y, omega.z, z, z],
                     axis=0)


def unpack_body_state(S):
    return (Vec3(S[0], S[1], S[2]), Vec3(S[3], S[4], S[5]))


def solve_rows(rc: RowConstraints, v: Vec3, omega: Vec3, inv_mass,
               inv_moment: Mat3, iters: int,
               friction_mode: str = "textbook", two_phase: bool = True,
               inner_iters: int = 1, warm=None, return_acc: bool = False,
               partner_term0: Vec3 = None, n_gather_rows: int = None,
               pallas_inner: bool = False, pallas_interpret: bool = False,
               col_offset: int = 0,
               state0=None, return_state: bool = False):
    """Scatter-free row sweeps.  ``v``/``omega``/masses cover M = N + statics
    rows; only bodies ``[col_offset, col_offset + rc.partner.shape[1])``
    are updated (``col_offset`` supports block solves over a type-sorted
    body range — the block's partner gathers still read GLOBAL state, so
    sequential block solves compose as two-color Gauss-Seidel).
    Returns updated (v, omega) for all M rows (statics unchanged).

    ``state0``/``return_state``: pass/return the packed (8, M) state so
    chained block solves avoid a pack/unpack round trip.

    ``inner_iters`` > 1 runs block-Jacobi inner sweeps with partner
    velocities frozen between gathers (the partner-state gather is the
    expensive op) — ``iters`` x ``inner_iters`` total sweeps with
    ``iters`` gathers.

    ``warm`` is an optional (acc_n, acc_t1, acc_t2) triple of (R, N)
    accumulated impulses from the previous frame (matched by the caller to
    this frame's rows): they are applied up front along this frame's
    normal/tangents and seed the accumulators — classic warm starting.
    The reference zeroes accumulators every frame (solver.rs:101-192);
    this is a documented stability EXTENSION (SURVEY §7.7), off by
    default.  With ``return_acc`` the final accumulators are returned for
    the next frame.

    ``partner_term0`` is the first sweep's frozen partner term
    (vb + omega_b x rb from the PRE-solve state), typically reused from
    the constraint precompute's gather; the warm pre-apply then counts as
    "iteration -1" of the block-Jacobi scheme (partner impulses land one
    sweep later — same convergence class, one fewer (8, R, N) gather).

    ``n_gather_rows`` (static): rows past this index have a STATIC partner
    (zero velocity — terrain rows from the fused iso path), so their
    partner term is identically zero and the per-sweep state gather only
    fetches the leading ``n_gather_rows`` rows — the single hottest gather
    in the whole step shrinks by the terrain-row fraction.

    ``pallas_inner``: run each outer iteration's inner sweeps as the fused
    Pallas kernel (ops/solver_sweep.py) — identical math, but the ~18
    (R, N) constraint channels are read once per OUTER iteration instead
    of once per sweep.  ``pallas_interpret`` runs it in the Pallas
    interpreter (CPU tests).  Requires the iso path (scalar
    ``inv_moment``), single-phase, textbook friction.
    """
    n = rc.partner.shape[1]
    lo, hi = col_offset, col_offset + n
    S = pack_body_state(v, omega) if state0 is None else state0
    ima = inv_mass[lo:hi]
    if isinstance(inv_moment, Mat3):
        Ia = jax.tree_util.tree_map(lambda g: g[lo:hi], inv_moment)
        apply_I = lambda vec: mat_vec(Ia, vec)
    else:
        # isotropic scalar inverse inertia array (spheres fast path)
        ia_s = inv_moment[lo:hi]
        apply_I = lambda vec: vec * ia_s

    R_tot = rc.partner.shape[0]
    gather_all = n_gather_rows is None or n_gather_rows >= R_tot

    def partner_term(S):
        # ROW-MAJOR state gather: transpose the packed (8, M) state to
        # (M, 8) and fetch one contiguous row per index instead of eight
        # strided minor-axis S[:, partner] reads; the per-iteration
        # transpose is small against the gather.
        T = S.T                                     # (M, 8)
        if gather_all:
            g = T[rc.partner]                       # (R, N, 8) one gather
            vb = Vec3(g[..., 0], g[..., 1], g[..., 2])
            ob = Vec3(g[..., 3], g[..., 4], g[..., 5])
            return vb + cross(ob, rc.rb)
        g = T[rc.partner[:n_gather_rows]]           # (K, N, 8): pair rows
        vb = Vec3(g[..., 0], g[..., 1], g[..., 2])
        ob = Vec3(g[..., 3], g[..., 4], g[..., 5])
        rbp = jax.tree_util.tree_map(lambda c: c[:n_gather_rows], rc.rb)
        term = vb + cross(ob, rbp)
        zt = jnp.zeros((R_tot - n_gather_rows, n), jnp.float32)
        return Vec3(jnp.concatenate([term.x, zt], axis=0),
                    jnp.concatenate([term.y, zt], axis=0),
                    jnp.concatenate([term.z, zt], axis=0))

    def self_term(S):
        va = Vec3(S[0, lo:hi][None], S[1, lo:hi][None], S[2, lo:hi][None])
        oa = Vec3(S[3, lo:hi][None], S[4, lo:hi][None], S[5, lo:hi][None])
        return va + cross(oa, rc.ra)

    def apply_self(S, imp: Vec3):
        """Row bodies receive -impulse (self is side a)."""
        imp = Vec3(imp.x * rc.valid, imp.y * rc.valid, imp.z * rc.valid)
        lin = Vec3(-imp.x.sum(0), -imp.y.sum(0), -imp.z.sum(0)) * ima
        ang_pt = -cross(rc.ra, imp)
        ang = apply_I(Vec3(ang_pt.x.sum(0), ang_pt.y.sum(0),
                           ang_pt.z.sum(0)))
        return S.at[:6, lo:hi].add(jnp.stack(
            [lin.x, lin.y, lin.z, ang.x, ang.y, ang.z], axis=0))

    def sweep_with(frozen, carry):
        def inner(carry2, _):
            S, acc_n, acc_t1, acc_t2 = carry2
            dv = frozen - self_term(S)
            f1, f2, acc_t1, acc_t2 = _friction_impulses(
                rc, dv, acc_t1, acc_t2, friction_mode, acc_n)
            if two_phase:
                S = apply_self(S, rc.t1 * f1 + rc.t2 * f2)
                dv = frozen - self_term(S)
                fn, acc_n = _normal_impulse(rc, dv, acc_n)
                S = apply_self(S, rc.normal * fn)
            else:
                fn, acc_n = _normal_impulse(rc, dv, acc_n)
                S = apply_self(S, rc.t1 * f1 + rc.t2 * f2 + rc.normal * fn)
            return (S, acc_n, acc_t1, acc_t2), None

        if inner_iters == 1:
            carry, _ = inner(carry, None)
        else:
            carry, _ = jax.lax.scan(inner, carry, None, length=inner_iters)
        return carry

    def sweep(carry, _):
        S = carry[0]
        return sweep_with(partner_term(S), carry), None

    zero = jnp.zeros(rc.valid.shape, jnp.float32)
    if warm is None:
        acc0 = (zero, zero, zero)
    else:
        wn, wt1, wt2 = [w * rc.valid for w in warm]
        S = apply_self(S, rc.t1 * wt1 + rc.t2 * wt2 + rc.normal * wn)
        acc0 = (wn, wt1, wt2)

    if pallas_inner:
        if (two_phase or friction_mode != "textbook"
                or isinstance(inv_moment, Mat3) or col_offset):
            raise ValueError("pallas_inner requires the single-phase "
                             "textbook-friction iso (scalar inertia) path "
                             "without a column offset")
        from mgf_tpu.ops import solver_sweep as _ss
        Rp = _ss.row_pad(R_tot)
        pad = (-n) % _ss.BLOCK
        padN = lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        padRN = lambda a: jnp.pad(a, [(0, 0), (0, Rp - R_tot), (0, pad)])
        fields = padRN(_ss.pack_row_fields(rc))
        self_p = padN(jnp.stack([ima, ia_s]))
        acc = padRN(jnp.stack(acc0))
        for k in range(iters):
            t = (partner_term0 if (k == 0 and partner_term0 is not None)
                 else partner_term(S))
            term = padRN(jnp.stack([t.x, t.y, t.z]))
            Sn, acc = _ss.inner_sweeps(padN(S[:, :n]), fields, term,
                                       self_p, acc, inner_iters,
                                       interpret=pallas_interpret)
            S = jnp.concatenate([Sn[:, :n], S[:, n:]], axis=1)
        acc = acc[:, :R_tot]
        out = S if return_state else unpack_body_state(S)
        if return_acc:
            acc3 = (acc[0, :, :n], acc[1, :, :n], acc[2, :, :n])
            return out + (acc3,) if not return_state else (out, acc3)
        return out

    carry = (S,) + acc0
    n_outer = iters
    if partner_term0 is not None and iters >= 1:
        carry = sweep_with(partner_term0, carry)
        n_outer = iters - 1
    (S, acc_n, acc_t1, acc_t2), _ = jax.lax.scan(
        sweep, carry, None, length=n_outer)
    if return_state:
        return (S, (acc_n, acc_t1, acc_t2)) if return_acc else S
    v_out, o_out = unpack_body_state(S)
    if return_acc:
        return v_out, o_out, (acc_n, acc_t1, acc_t2)
    return v_out, o_out
