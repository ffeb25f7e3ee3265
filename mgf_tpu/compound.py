"""Compound shapes: aggregates of sphere/capsule components.

Counterpart of ``src/compound.rs``.  The reference's runtime
``Component`` enum is the engine-wide (shape_type, r, half_h) encoding
(physics.SHAPE_*); this module adds the aggregate :class:`Compound` — a set
of components with a shared displacement + rotation (compound.rs:232-242).
Where mgf accelerates per-component lookup with a BVH, compounds here are
small fixed-size batches tested densely (compound bodies typically have a
handful of parts; the broadphase already culled the pair).

Provided (compound.rs parity):
* component construct/deconstruct — physics.py (compound.rs:42-52, 217-228),
* Compound contacts vs a moving sphere/capsule (compound.rs:334-352):
  components are rotated into world (rotate_about the compound origin,
  compound.rs:347) and every component emits contacts, flipped so the
  compound is the receiver,
* Compound raytrace (Intersects, compound.rs:309-332),
* compound inertia: the summed parallel-axis tensor (physics.rs:86-93 +
  CHANGELOG v1.3 note).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu.collision import (
    Contact, Intersection, contact_capsule_moving_capsule,
    contact_capsule_moving_sphere, contact_neg, contact_select,
    contact_sphere_moving_capsule, contact_sphere_moving_sphere,
    intersect_capsule, intersect_sphere,
)
from mgf_tpu.geom import Capsule, Sphere
from mgf_tpu.math3d import (
    Mat3, Quat, Vec3, mat_inv3, qconj, qmul, qrotate, vfrom, vzeros_like,
)
from mgf_tpu.physics import (
    SHAPE_CAPSULE, SHAPE_SPHERE, capsule_tensor, sphere_tensor,
)


class Compound(NamedTuple):
    """An aggregate of components with a displacement + rotation
    (compound.rs:232-242).  Component fields are (P,) SoA in the compound's
    local frame."""
    disp: Vec3               # world displacement
    rot: Quat                # world rotation (assumed normalized)
    kind: jnp.ndarray        # (P,) int32 SHAPE_*
    local_x: Vec3            # (P,) component centers (local frame)
    local_q: Quat            # (P,) component orientations (local frame)
    r: jnp.ndarray           # (P,)
    half_h: jnp.ndarray      # (P,)

    @property
    def n_parts(self):
        return self.r.shape[0]


def compound_from_parts(parts, disp=(0.0, 0.0, 0.0)) -> Compound:
    """Host-side builder.  ``parts`` is a list of dicts:
    {"kind": "sphere"|"capsule", "center"|("a","d"), "r"}."""
    kinds, xs, qs, rs, hh = [], [], [], [], []
    from mgf_tpu.physics import _np_quat_from_arc_y
    for p in parts:
        if p["kind"] == "sphere":
            kinds.append(SHAPE_SPHERE)
            xs.append(np.asarray(p["center"], np.float32))
            qs.append(np.asarray([1, 0, 0, 0], np.float32))
            hh.append(0.0)
        else:
            a = np.asarray(p["a"], np.float64)
            d = np.asarray(p["d"], np.float64)
            kinds.append(SHAPE_CAPSULE)
            xs.append((a + d * 0.5).astype(np.float32))
            qs.append(_np_quat_from_arc_y(d[None])[0])
            hh.append(float(np.linalg.norm(d)) * 0.5)
        rs.append(float(p["r"]))
    from mgf_tpu.math3d import qfrom
    return Compound(
        disp=vfrom(jnp.asarray(np.asarray(disp, np.float32))),
        rot=Quat(jnp.float32(1), jnp.float32(0), jnp.float32(0),
                 jnp.float32(0)),
        kind=jnp.asarray(np.asarray(kinds, np.int32)),
        local_x=vfrom(jnp.asarray(np.stack(xs))),
        local_q=qfrom(jnp.asarray(np.stack(qs))),
        r=jnp.asarray(np.asarray(rs, np.float32)),
        half_h=jnp.asarray(np.asarray(hh, np.float32)))


def compound_world_components(c: Compound):
    """Components rotated about the origin + displaced
    (compound.rs:347: rotate_about(rot, origin) + disp).
    Returns (Sphere (P,), Capsule (P,), kind)."""
    x = qrotate(c.rot, c.local_x) + c.disp
    q = qmul(c.rot, c.local_q)
    zero = jnp.zeros_like(c.half_h)
    d_half = qrotate(q, Vec3(zero, c.half_h, zero))
    return (Sphere(c=x, r=c.r),
            Capsule(a=x - d_half, d=d_half * 2.0, r=c.r),
            c.kind)


def compound_contacts(c: Compound, shape, v: Vec3) -> Contact:
    """Contacts<RHS> for Compound (compound.rs:334-352): every component is
    tested against the moving shape and contacts are flipped so the compound
    is the receiver.  Returns a Contact batch with leading component axis
    (P,); callers prune (the reference's callback just fires per leaf).

    ``shape`` is a single Sphere or Capsule; ``v`` its sweep.
    """
    spheres, capsules, kind = compound_world_components(c)
    P = c.n_parts
    b = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (P,) + jnp.shape(x)), t)
    if isinstance(shape, Sphere):
        cs = contact_sphere_moving_sphere(spheres, b(shape), b(v))
        cc = contact_capsule_moving_sphere(capsules, b(shape), b(v))
    else:
        cs = contact_sphere_moving_capsule(spheres, b(shape), b(v))
        cc = contact_capsule_moving_capsule(capsules, b(shape), b(v))
    out = contact_select(kind == SHAPE_SPHERE, cs, cc)
    return out


def compound_raytrace(c: Compound, p: Vec3, d: Vec3, dt=jnp.inf
                      ) -> Intersection:
    """Ray/segment vs Compound (Intersects, compound.rs:309-332): the ray is
    rotated into the compound frame, tested per component, min-t wins."""
    conj = qconj(c.rot)
    p_l = qrotate(conj, p - c.disp) + c.disp
    d_l = qrotate(conj, d)
    # reference tests the *rotated* components against the local ray
    # (compound.rs:320: shape = comp.rotate(rhs.rot) + rhs.disp)
    x = qrotate(c.rot, c.local_x) + c.disp
    q = qmul(c.rot, c.local_q)
    zero = jnp.zeros_like(c.half_h)
    d_half = qrotate(q, Vec3(zero, c.half_h, zero))
    spheres = Sphere(c=x, r=c.r)
    capsules = Capsule(a=x - d_half, d=d_half * 2.0, r=c.r)

    P = c.n_parts
    b = lambda t: jax.tree_util.tree_map(
        lambda g: jnp.broadcast_to(g, (P,) + jnp.shape(g)), t)
    i_s = intersect_sphere(b(p_l), b(d_l), dt, spheres)
    i_c = intersect_capsule(b(p_l), b(d_l), dt, capsules)
    hit_s = i_s.hit & (c.kind == SHAPE_SPHERE)
    hit_c = i_c.hit & (c.kind == SHAPE_CAPSULE)
    t = jnp.where(hit_s, i_s.t, jnp.where(hit_c, i_c.t, jnp.inf))
    best = jnp.argmin(t, axis=0)
    pick = lambda arr: jnp.take(arr, best, axis=0)
    hit_any = jnp.min(t, axis=0) < jnp.inf
    pt = jax.tree_util.tree_map(
        pick, jax.tree_util.tree_map(
            lambda a, b_: jnp.where(c.kind.reshape(
                (-1,) + (1,) * (a.ndim - 1)) == SHAPE_SPHERE, a, b_),
            i_s.p, i_c.p))
    return Intersection(p=pt, t=pick(t), hit=hit_any)


def compound_inertia(c: Compound, mass) -> Mat3:
    """Summed component tensors with parallel-axis terms about the compound
    origin, mass split evenly (Inertia for Component, physics.rs:86-93;
    parallel-axis support per CHANGELOG v1.3).  Returns the inverse tensor.
    """
    P = c.n_parts
    m_part = mass / P
    zero = jnp.zeros_like(c.half_h)
    d_half = qrotate(c.local_q, Vec3(zero, c.half_h, zero))
    t_sph = sphere_tensor(c.local_x, c.r, jnp.full((P,), m_part))
    t_cap = capsule_tensor(c.local_x - d_half, d_half * 2.0, c.r,
                           jnp.full((P,), m_part))
    sel = (c.kind == SHAPE_SPHERE)
    t = Mat3(*(jnp.where(sel, a, b) for a, b in zip(t_sph, t_cap)))
    total = Mat3(*(comp.sum(axis=0) for comp in t))
    return mat_inv3(total)


def compound_contacts_polygon(c: Compound, poly, v: Vec3) -> Contact:
    """Contacts between a Compound and a moving Triangle/Rectangle
    (Contacts<RHS> for Compound with a polygon RHS, compound.rs:334-352:
    every component collides the moving polygon; results are flipped so the
    compound is the receiver).  Returns slots (2, P) over components."""
    from mgf_tpu.collision import (
        contact_rectangle_moving_capsule, contact_rectangle_moving_sphere,
        contact_sphere_moving_capsule, contact_stack,
        contact_triangle_moving_capsule, contact_triangle_moving_sphere,
        contact_moving_static, contact_advect,
    )
    from mgf_tpu.geom import Rectangle, Triangle

    spheres, capsules, kind = compound_world_components(c)
    P = c.n_parts
    b = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (P,) + jnp.shape(x)), t)
    polyb = b(poly)
    vb = b(v)
    # the reference dispatches rhs.contacts(&component_shape): the polygon is
    # the receiver of a component moving at -v, advected + flipped twice
    # (compound commute) -> net: polygon receiver vs component swept by -v,
    # then advect by v*t and flip so the compound is side a.
    if isinstance(poly, Triangle):
        f_s = contact_triangle_moving_sphere
        f_c = contact_triangle_moving_capsule
    else:
        f_s = contact_rectangle_moving_sphere
        f_c = contact_rectangle_moving_capsule
    cs = f_s(polyb, spheres, -vb)
    cs2 = contact_stack([cs, cs._replace(valid=jnp.zeros_like(cs.valid))])
    cc = f_c(polyb, capsules, -vb)
    out = contact_select((kind == SHAPE_SPHERE)[None, :], cs2, cc)
    out = contact_advect(out, vb * out.t)
    return contact_neg(out)
