"""Vector / quaternion / 3x3-matrix math, in component form.

The mgf reference delegates this layer to the ``cgmath`` crate (src/lib.rs:114).
Here 3-vectors are :class:`Vec3` pytrees of three *separate* scalar arrays,
quaternions are :class:`Quat` (w, x, y, z component arrays), and 3x3 matrices
are :class:`Mat3` (nine component arrays).

Why components instead of ``(..., 3)`` arrays: an ``(N, 3)`` array puts the
three components in the minor dimension, so every elementwise op works on
a 3-wide inner axis that vector hardware pads or strides over, and every
cross/dot product shuffles within it.  Component arrays of shape ``(N,)``
are contiguous along the batch, so each op is one dense elementwise pass
that XLA fuses freely (the engine's first accelerator padded the minor
dimension to 128; the H100 cost of the ``(N, 3)`` form is not measured).

All ops broadcast: a Vec3 of scalars and a Vec3 of (N,) arrays combine like
jnp scalars/arrays.  Guarded ``safe_*`` variants never produce NaN/Inf from
masked-out lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Maximum tolerance for error (reference: geom.rs:27).
COLLISION_EPSILON = 1e-6


# ---------------------------------------------------------------------------
# scalar helpers
# ---------------------------------------------------------------------------

def safe_div(num, den, default=0.0):
    """num / den where den != 0, else default; never NaN/Inf from 0/0."""
    ok = den != 0.0
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), default)


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def clamp(n, lo, hi):
    return jnp.clip(n, lo, hi)


# ---------------------------------------------------------------------------
# Vec3
# ---------------------------------------------------------------------------

class Vec3(NamedTuple):
    """A 3-vector as three component arrays (a pytree)."""
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (overrides tuple concat/repeat) --
    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        """Scale by a scalar (array); for elementwise Vec3*Vec3 use vmul."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __getitem__(self, idx):
        """Index/slice every component (e.g. gather by an index array)."""
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    @property
    def shape(self):
        return jnp.shape(self.x)

    @property
    def dtype(self):
        return jnp.asarray(self.x).dtype


def vec3(x, y, z, dtype=jnp.float32):
    x, y, z = (jnp.asarray(v, dtype) for v in (x, y, z))
    x, y, z = jnp.broadcast_arrays(x, y, z)
    return Vec3(x, y, z)


def vsplat(s):
    """Vec3 with all components equal to the scalar array s."""
    s = jnp.asarray(s, jnp.float32)
    return Vec3(s, s, s)


def vzero(shape=(), dtype=jnp.float32):
    z = jnp.zeros(shape, dtype)
    return Vec3(z, z, z)


def vzeros_like(v: Vec3):
    return Vec3(jnp.zeros_like(v.x), jnp.zeros_like(v.y),
                jnp.zeros_like(v.z))


def vbroadcast(v: Vec3, shape):
    return Vec3(*(jnp.broadcast_to(c, shape) for c in v))


def vfrom(a):
    """(…, 3) array -> Vec3."""
    a = jnp.asarray(a)
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def vto(v: Vec3):
    """Vec3 -> (…, 3) array (host/boundary use only)."""
    return jnp.stack(jnp.broadcast_arrays(v.x, v.y, v.z), axis=-1)


def vmul(a: Vec3, b: Vec3) -> Vec3:
    """Elementwise (Hadamard) product."""
    return Vec3(a.x * b.x, a.y * b.y, a.z * b.z)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def magnitude2(v: Vec3):
    return dot(v, v)


def magnitude(v: Vec3):
    return jnp.sqrt(magnitude2(v))


def normalize(v: Vec3) -> Vec3:
    return v * (1.0 / magnitude(v))


def safe_normalize(v: Vec3, fallback: Vec3 | None = None, eps=0.0) -> Vec3:
    m2 = magnitude2(v)
    ok = m2 > eps * eps
    inv = jnp.where(ok, 1.0 / safe_sqrt(jnp.where(ok, m2, 1.0)), 0.0)
    out = v * inv
    if fallback is not None:
        out = where_vec(ok, out, fallback)
    return out


def where_vec(cond, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(cond, a.x, b.x), jnp.where(cond, a.y, b.y),
                jnp.where(cond, a.z, b.z))


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y),
                jnp.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y),
                jnp.maximum(a.z, b.z))


def vabs(v: Vec3) -> Vec3:
    return Vec3(jnp.abs(v.x), jnp.abs(v.y), jnp.abs(v.z))


def vclamp(v: Vec3, lo: Vec3, hi: Vec3) -> Vec3:
    return vmin(vmax(v, lo), hi)


def vall_le(a: Vec3, b: Vec3):
    """componentwise a <= b, reduced with AND."""
    return (a.x <= b.x) & (a.y <= b.y) & (a.z <= b.z)


def perpendicular(v: Vec3) -> Vec3:
    """Some unit vector perpendicular to v (cgmath from_arc fallback rule)."""
    zero = jnp.zeros_like(v.x)
    w1 = cross(Vec3(jnp.ones_like(v.x), zero, zero), v)
    w2 = cross(Vec3(zero, jnp.ones_like(v.x), zero), v)
    use1 = magnitude2(w1) > COLLISION_EPSILON
    return safe_normalize(where_vec(use1, w1, w2))


# ---------------------------------------------------------------------------
# Quat (w, x, y, z) — cgmath's scalar-first convention
# ---------------------------------------------------------------------------

class Quat(NamedTuple):
    w: jnp.ndarray
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    @property
    def v(self) -> Vec3:
        return Vec3(self.x, self.y, self.z)

    def __add__(self, o):
        return Quat(self.w + o.w, self.x + o.x, self.y + o.y, self.z + o.z)

    def __mul__(self, s):
        return Quat(self.w * s, self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __getitem__(self, idx):
        return Quat(self.w[idx], self.x[idx], self.y[idx], self.z[idx])

    @property
    def shape(self):
        return jnp.shape(self.w)


def quat(w, x, y, z, dtype=jnp.float32):
    w, x, y, z = (jnp.asarray(v, dtype) for v in (w, x, y, z))
    w, x, y, z = jnp.broadcast_arrays(w, x, y, z)
    return Quat(w, x, y, z)


def quat_identity(shape=(), dtype=jnp.float32):
    return Quat(jnp.ones(shape, dtype), jnp.zeros(shape, dtype),
                jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def quat_from_sv(s, v: Vec3) -> Quat:
    return Quat(jnp.asarray(s), v.x, v.y, v.z)


def qfrom(a):
    """(…, 4) wxyz array -> Quat."""
    a = jnp.asarray(a)
    return Quat(a[..., 0], a[..., 1], a[..., 2], a[..., 3])


def qto(q: Quat):
    return jnp.stack(jnp.broadcast_arrays(q.w, q.x, q.y, q.z), axis=-1)


def qmul(p: Quat, q: Quat) -> Quat:
    """Hamilton product p * q."""
    w = p.w * q.w - (p.x * q.x + p.y * q.y + p.z * q.z)
    v = p.v * q.w + q.v * p.w + cross(p.v, q.v)
    return Quat(w, v.x, v.y, v.z)


def qconj(q: Quat) -> Quat:
    return Quat(q.w, -q.x, -q.y, -q.z)


def qnorm2(q: Quat):
    return q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z


def qnormalize(q: Quat) -> Quat:
    m2 = qnorm2(q)
    ok = m2 > 0.0
    inv = jnp.where(ok, 1.0 / safe_sqrt(jnp.where(ok, m2, 1.0)), 0.0)
    out = q * inv
    return Quat(jnp.where(ok, out.w, 1.0), jnp.where(ok, out.x, 0.0),
                jnp.where(ok, out.y, 0.0), jnp.where(ok, out.z, 0.0))


def qrotate(q: Quat, v: Vec3) -> Vec3:
    """Rotate v by unit quaternion q: v + 2 u x (u x v + w v)."""
    u = q.v
    t = cross(u, v) * 2.0
    return v + t * q.w + cross(u, t)


def quat_from_axis_angle(axis: Vec3, angle) -> Quat:
    half = 0.5 * jnp.asarray(angle)
    return quat_from_sv(jnp.cos(half), axis * jnp.sin(half))


def quat_from_arc(src: Vec3, dst: Vec3) -> Quat:
    """Shortest-arc rotation src -> dst; cgmath ``from_arc(src, dst, None)``
    semantics (non-unit inputs ok, antiparallel spins pi around an arbitrary
    perpendicular axis).  Used for capsule frames (physics.rs:70,
    compound.rs:48)."""
    mag_avg = safe_sqrt(magnitude2(src) * magnitude2(dst))
    d = dot(src, dst)
    general = qnormalize(quat_from_sv(mag_avg + d, cross(src, dst)))
    anti = quat_from_sv(jnp.zeros_like(d), perpendicular(src))
    is_anti = d < -mag_avg * (1.0 - 1e-6)
    return Quat(*(jnp.where(is_anti, a, g)
                  for a, g in zip(anti, general)))


# ---------------------------------------------------------------------------
# Mat3 — row-major 3x3 as nine component arrays
# ---------------------------------------------------------------------------

class Mat3(NamedTuple):
    xx: jnp.ndarray
    xy: jnp.ndarray
    xz: jnp.ndarray
    yx: jnp.ndarray
    yy: jnp.ndarray
    yz: jnp.ndarray
    zx: jnp.ndarray
    zy: jnp.ndarray
    zz: jnp.ndarray

    def __add__(self, o):
        return Mat3(*(a + b for a, b in zip(self, o)))

    def __sub__(self, o):
        return Mat3(*(a - b for a, b in zip(self, o)))

    def __mul__(self, s):
        return Mat3(*(a * s for a in self))

    __rmul__ = __mul__

    def __getitem__(self, idx):
        return Mat3(*(a[idx] for a in self))

    def row(self, i) -> Vec3:
        return (Vec3(self.xx, self.xy, self.xz),
                Vec3(self.yx, self.yy, self.yz),
                Vec3(self.zx, self.zy, self.zz))[i]


def mat3_rows(r0: Vec3, r1: Vec3, r2: Vec3) -> Mat3:
    return Mat3(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, r2.x, r2.y, r2.z)


def mat_vec(m: Mat3, v: Vec3) -> Vec3:
    return Vec3(m.xx * v.x + m.xy * v.y + m.xz * v.z,
                m.yx * v.x + m.yy * v.y + m.yz * v.z,
                m.zx * v.x + m.zy * v.y + m.zz * v.z)


def mat_mul(a: Mat3, b: Mat3) -> Mat3:
    return Mat3(
        a.xx * b.xx + a.xy * b.yx + a.xz * b.zx,
        a.xx * b.xy + a.xy * b.yy + a.xz * b.zy,
        a.xx * b.xz + a.xy * b.yz + a.xz * b.zz,
        a.yx * b.xx + a.yy * b.yx + a.yz * b.zx,
        a.yx * b.xy + a.yy * b.yy + a.yz * b.zy,
        a.yx * b.xz + a.yy * b.yz + a.yz * b.zz,
        a.zx * b.xx + a.zy * b.yx + a.zz * b.zx,
        a.zx * b.xy + a.zy * b.yy + a.zz * b.zy,
        a.zx * b.xz + a.zy * b.yz + a.zz * b.zz,
    )


def mat_t(m: Mat3) -> Mat3:
    return Mat3(m.xx, m.yx, m.zx, m.xy, m.yy, m.zy, m.xz, m.yz, m.zz)


def mat_diag(x, y, z) -> Mat3:
    x = jnp.asarray(x)
    zero = jnp.zeros_like(x)
    return Mat3(x, zero, zero, zero, jnp.asarray(y), zero, zero, zero,
                jnp.asarray(z))


def mat_identity(shape=(), dtype=jnp.float32):
    one = jnp.ones(shape, dtype)
    zero = jnp.zeros(shape, dtype)
    return Mat3(one, zero, zero, zero, one, zero, zero, zero, one)


def mat_zero(shape=(), dtype=jnp.float32):
    z = jnp.zeros(shape, dtype)
    return Mat3(z, z, z, z, z, z, z, z, z)


def outer(a: Vec3, b: Vec3) -> Mat3:
    return Mat3(a.x * b.x, a.x * b.y, a.x * b.z,
                a.y * b.x, a.y * b.y, a.y * b.z,
                a.z * b.x, a.z * b.y, a.z * b.z)


def mfrom(a):
    """(…, 3, 3) array -> Mat3."""
    a = jnp.asarray(a)
    return Mat3(a[..., 0, 0], a[..., 0, 1], a[..., 0, 2],
                a[..., 1, 0], a[..., 1, 1], a[..., 1, 2],
                a[..., 2, 0], a[..., 2, 1], a[..., 2, 2])


def mto(m: Mat3):
    parts = jnp.broadcast_arrays(*m)
    return jnp.stack(parts, axis=-1).reshape(jnp.shape(parts[0]) + (3, 3))


def mat_inv3(m: Mat3) -> Mat3:
    """Closed-form inverse (adjugate/det); zero matrix for singular lanes."""
    c00 = m.yy * m.zz - m.yz * m.zy
    c01 = m.yz * m.zx - m.yx * m.zz
    c02 = m.yx * m.zy - m.yy * m.zx
    det = m.xx * c00 + m.xy * c01 + m.xz * c02
    inv_det = safe_div(jnp.ones_like(det), det)
    return Mat3(
        c00 * inv_det,
        (m.xz * m.zy - m.xy * m.zz) * inv_det,
        (m.xy * m.yz - m.xz * m.yy) * inv_det,
        c01 * inv_det,
        (m.xx * m.zz - m.xz * m.zx) * inv_det,
        (m.xz * m.yx - m.xx * m.yz) * inv_det,
        c02 * inv_det,
        (m.xy * m.zx - m.xx * m.zy) * inv_det,
        (m.xx * m.yy - m.xy * m.yx) * inv_det,
    )


def quat_to_mat(q: Quat) -> Mat3:
    w, x, y, z = q.w, q.x, q.y, q.z
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return Mat3(
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )
