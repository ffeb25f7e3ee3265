"""GJK/EPA tests: ports of the reference's sphere-penetration and OBB
contact goldens (collision.rs:1646-1671, 1822-1843)."""

import functools

import jax.numpy as jnp
import pytest

from helpers import V, F, assert_vec

from mgf_tpu.geom import (
    OBB, Sphere, support_obb, support_sphere,
)
from mgf_tpu.gjk import contact_convex_convex, separation
from mgf_tpu.math3d import quat, quat_from_arc


def sphere_support(s):
    return lambda d: support_sphere(s, d)


def obb_support(o):
    return lambda d: support_obb(o, d)


def test_sphere_penetration():
    # collision.rs:1646-1671
    one = jnp.float32(1.0)
    s1 = Sphere(c=V(0, 0, 0), r=F(1.0))
    s2 = Sphere(c=V(2, 0, 0), r=F(1.5))
    d, sep = separation(sphere_support(s1), sphere_support(s2), one)
    assert not bool(sep)  # overlapping -> None in the reference
    d, sep = separation(sphere_support(s2), sphere_support(s1), one)
    assert not bool(sep)
    s3 = Sphere(c=V(2, 0, 0), r=F(0.75))
    d, sep = separation(sphere_support(s1), sphere_support(s3), one)
    assert bool(sep)
    assert float(d) == pytest.approx(0.25, abs=1e-4)


def _ident():
    return quat(1.0, 0.0, 0.0, 0.0)


def test_obb_contacts():
    # collision.rs:1822-1843
    one = jnp.float32(1.0)
    box1 = OBB(c=V(0, 0, 0), q=_ident(), r=V(1, 1, 1))
    box2 = OBB(c=V(0, 1, 0), q=_ident(), r=V(1, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box2), one)
    assert bool(c.valid)
    assert float(c.a.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.b.y) == pytest.approx(-0.5, abs=1e-3)

    c = contact_convex_convex(obb_support(box2), obb_support(box1), one)
    assert bool(c.valid)
    assert float(c.b.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.a.y) == pytest.approx(-0.5, abs=1e-3)

    box3 = OBB(c=V(0, 4.1, 0), q=_ident(), r=V(1, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box3), one)
    assert not bool(c.valid)

    box4 = OBB(c=V(0, 2.0, 0), q=quat_from_arc(V(1, 0, 0), V(0, 1, 0)),
               r=V(1.7, 1.5, 1))
    c = contact_convex_convex(obb_support(box1), obb_support(box4), one)
    assert bool(c.valid)
    assert float(c.a.y) == pytest.approx(1.0, abs=1e-3)
    assert float(c.b.y) == pytest.approx(0.3, abs=2e-3)


def test_gjk_batched():
    # a batch of sphere pairs, some separated, some penetrating
    import numpy as np
    from mgf_tpu.math3d import Vec3
    n = 8
    cx = jnp.linspace(1.0, 4.0, n)
    c1 = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.zeros(n))
    c2 = Vec3(cx, jnp.zeros(n), jnp.zeros(n))
    sup1 = lambda d: support_sphere(Sphere(c=c1, r=jnp.ones(n)), d)
    sup2 = lambda d: support_sphere(Sphere(c=c2, r=jnp.full(n, 0.5)), d)
    dist, sep = separation(sup1, sup2, jnp.ones(n))
    expected_gap = np.asarray(cx) - 1.5
    for i in range(n):
        if expected_gap[i] > 1e-3:
            assert bool(sep[i])
            assert float(dist[i]) == pytest.approx(expected_gap[i], abs=1e-3)
        else:
            assert not bool(sep[i])


def test_epa_horizon_pick_is_exact():
    """The EPA horizon pick is an index gather: each picked vertex is
    bit-equal to its source edge (a float matrix product here would lose
    bits in TF32 on a GPU)."""
    import numpy as np
    from mgf_tpu.gjk import horizon_pick

    rng = np.random.default_rng(0)
    T, E, B = 8, 12, 5
    x = jnp.asarray(rng.standard_normal((E, B)) * 1e3 + 1e-7, jnp.float32)
    match = np.zeros((T, E, B), bool)
    src = np.full((T, B), -1)
    for b in range(B):
        edges = rng.permutation(E)[:T - 2]      # two slots stay unmatched
        for t, e in enumerate(edges):
            match[t, e, b] = True
            src[t, b] = e
    got = np.asarray(horizon_pick(jnp.asarray(match), x))
    xs = np.asarray(x)
    for t in range(T):
        for b in range(B):
            if src[t, b] >= 0:
                assert got[t, b].view(np.int32) == \
                    xs[src[t, b], b].view(np.int32)
