"""Triangle meshes and convex point-soup meshes.

Counterpart of ``src/mesh.rs``:

* :class:`Mesh` — a non-convex triangle soup with a displacement, the
  reference's ``Mesh`` (mesh.rs:32-37).  Where mgf accelerates face lookup
  with a pointer BVH, collision here is a dense masked test against all (or
  grid-culled) faces — the world step uses it for terrain; a static
  triangle cell grid (:func:`build_mesh_grid`) provides the broadphase-style
  culling for large meshes (the BVH::query equivalent, mesh.rs:121).
* :class:`ConvexMesh` — a closed convex point soup with a linear-scan
  support function (mesh.rs:144-236), usable with the GJK/EPA kernels for
  the generic convex Contacts/Penetrates.

Contacts against a Mesh are emitted flipped so the mesh is the receiver
(mesh.rs:127-134): a = point on the mesh, b = point on the other shape,
n = -n_tri.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mgf_tpu.collision import (
    Contact, contact_neg, contact_stack, contact_triangle_moving_capsule,
    contact_triangle_moving_sphere,
)
from mgf_tpu.geom import Capsule, Sphere, Triangle
from mgf_tpu.math3d import Vec3, dot, qrotate, vfrom, vzeros_like


class Mesh(NamedTuple):
    """Triangle soup + displacement (mesh.rs:32-37).  ``verts`` are Vec3 of
    (V,) components; ``faces`` is (T, 3) int32."""
    x: Vec3
    verts: Vec3
    faces: jnp.ndarray

    @property
    def n_faces(self):
        return self.faces.shape[0]


def mesh_from_arrays(verts, faces, x=(0.0, 0.0, 0.0)) -> Mesh:
    """Host-side constructor (Mesh::push_vert/push_face, mesh.rs:58-73)."""
    v = vfrom(jnp.asarray(np.asarray(verts, np.float32)))
    return Mesh(x=vfrom(jnp.asarray(np.asarray(x, np.float32))),
                verts=v, faces=jnp.asarray(np.asarray(faces, np.int32)))


def mesh_set_pos(m: Mesh, p: Vec3) -> Mesh:
    """Shape::set_pos for Mesh — center is ``x`` (mesh.rs:89-91)."""
    return m._replace(x=p)


def mesh_triangles(m: Mesh) -> Triangle:
    """World-space triangle batch (T,) — the faces displaced by x
    (mesh.rs:122-126)."""
    f = m.faces
    pick = lambda i: jax.tree_util.tree_map(lambda c: c[f[:, i]], m.verts)
    return Triangle(a=pick(0) + m.x, b=pick(1) + m.x, c=pick(2) + m.x)


def rotate_mesh(m: Mesh, q) -> Mesh:
    """Rotate all vertices (Volumetric for Mesh, mesh.rs:100-113; the
    reference rebuilds its BVH — our grid accel is likewise rebuilt by the
    caller if used)."""
    return m._replace(verts=qrotate(q, m.verts))


def mesh_contacts(m: Mesh, shape, v: Vec3, face_mask=None) -> Contact:
    """Mesh vs a moving Sphere or Capsule; returns flipped contacts with
    leading axes (slots..., T)."""
    tris = mesh_triangles(m)
    T = tris.a.x.shape[0]
    bshape = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (T,) + jnp.shape(x)), shape)
    bv = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (T,) + jnp.shape(x)), v)
    if isinstance(shape, Sphere):
        c = contact_triangle_moving_sphere(tris, bshape, bv)
        c = contact_stack([c, c._replace(valid=jnp.zeros_like(c.valid))])
    else:
        c = contact_triangle_moving_capsule(tris, bshape, bv)
    if face_mask is not None:
        c = c._replace(valid=c.valid & face_mask[None, :])
    # flip: mesh is the receiver (mesh.rs:127-134)
    return contact_neg(c)


# ---------------------------------------------------------------------------
# static face grid — the Mesh BVH equivalent for large meshes
# ---------------------------------------------------------------------------

class MeshGrid(NamedTuple):
    """Cell -> face-id table over a mesh's triangles (replaces the per-face
    BVH of mesh.rs:36, built once for a static mesh)."""
    table: jnp.ndarray      # (dim^3, cap) int32 face id or -1
    cell_size: float
    dim: int
    overflow: jnp.ndarray


def build_mesh_grid(m: Mesh, cell_size: float, dim: int = 64,
                    cap: int = 8) -> MeshGrid:
    """Bin each face into EVERY cell its AABB overlaps (host- or
    device-side).  The documented sizing contract is cell_size >= the
    largest face RADIUS, i.e. face extent up to 2*cell_size, which spans
    at most 3 cells per axis — so 27 insertion slots per face (masked to
    the actual AABB span; small faces insert once).  The DDA raytrace and
    the +-1-cell query window can then test exactly the visited cell —
    any face crossing cell c overlaps c and is present in c's bucket.
    (Centroid-only binning missed boundary-straddling faces entirely when
    the mesh was not grid-aligned.)  Larger faces need a finer
    tessellation or the dense path."""
    tris = mesh_triangles(m)
    n = m.n_faces
    cc = lambda comp: jnp.floor(comp / cell_size).astype(jnp.int32)
    # shrink the face AABB by a hair before binning: a face that merely
    # TOUCHES a boundary plane (grid-aligned meshes touch on every face)
    # need not occupy the neighbor cell — an intersection exactly on the
    # plane is found in whichever adjacent cell the DDA tests, since the
    # hit t equals that cell's entry/exit t.  Keeps buckets ~8x lighter
    # for aligned meshes at a sub-roundoff exactness cost.
    eps = 1e-5 * cell_size
    lo_ = lambda u, v, w: cc(jnp.minimum(jnp.minimum(u, v), w) + eps)
    hi_ = lambda u, v, w: cc(jnp.maximum(jnp.maximum(u, v), w) - eps)
    lo = [lo_(tris.a.x, tris.b.x, tris.c.x),
          lo_(tris.a.y, tris.b.y, tris.c.y),
          lo_(tris.a.z, tris.b.z, tris.c.z)]
    hi = [jnp.maximum(hi_(tris.a.x, tris.b.x, tris.c.x), lo[0]),
          jnp.maximum(hi_(tris.a.y, tris.b.y, tris.c.y), lo[1]),
          jnp.maximum(hi_(tris.a.z, tris.b.z, tris.c.z), lo[2])]
    mmask = dim - 1
    hs, oks = [], []
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                cx = lo[0] + dx
                cy = lo[1] + dy
                cz = lo[2] + dz
                # skip offsets past the face's AABB (no duplicate inserts
                # for faces that span fewer cells along an axis)
                oks.append((cx <= hi[0]) & (cy <= hi[1]) & (cz <= hi[2]))
                hs.append((((cx & mmask) * dim + (cy & mmask)) * dim
                           + (cz & mmask)))
    h = jnp.concatenate(hs)                        # (27N,)
    ins_ok = jnp.concatenate(oks)
    face = jnp.tile(jnp.arange(n, dtype=jnp.int32), 27)
    from mgf_tpu.broadphase import _bucket_ranks
    sentinel = jnp.int32(dim ** 3)                 # invalid slots sort last
    hk = jnp.where(ins_ok, h, sentinel)
    order = jnp.argsort(hk)
    sorted_h = hk[order]
    rank = _bucket_ranks(sorted_h, 27 * n)
    ok = (rank < cap) & (sorted_h < sentinel)
    table = jnp.full((dim ** 3, cap), -1, jnp.int32)
    # sentinel rows are out of bounds -> dropped by mode='drop'
    table = table.at[sorted_h, jnp.minimum(rank, cap - 1)].set(
        jnp.where(ok, face[order], -1), mode='drop')
    return MeshGrid(table=table, cell_size=cell_size, dim=dim,
                    overflow=jnp.sum((rank >= cap) & (sorted_h < sentinel))
                    .astype(jnp.int32))


def mesh_grid_query(grid: MeshGrid, centers: Vec3):
    """(N, 27*cap) candidate face ids around each query point (the
    BVH::query equivalent for meshes, mesh.rs:121)."""
    cc = lambda comp: jnp.floor(comp / grid.cell_size).astype(jnp.int32)
    cx, cy, cz = cc(centers.x), cc(centers.y), cc(centers.z)
    mmask = grid.dim - 1
    cols = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                h = ((((cx + dx) & mmask) * grid.dim + ((cy + dy) & mmask))
                     * grid.dim + ((cz + dz) & mmask))
                cols.append(grid.table[h])
    return jnp.concatenate(cols, axis=-1)


# ---------------------------------------------------------------------------
# ConvexMesh (mesh.rs:144-236)
# ---------------------------------------------------------------------------

class ConvexMesh(NamedTuple):
    """Closed convex point soup: displacement + vertices (mesh.rs:144-148).
    ``center`` is x + mean(verts) (mesh.rs:203-206)."""
    x: Vec3
    verts: Vec3   # (V,) components


def convex_mesh_from_points(points, x=(0.0, 0.0, 0.0)) -> ConvexMesh:
    return ConvexMesh(x=vfrom(jnp.asarray(np.asarray(x, np.float32))),
                      verts=vfrom(jnp.asarray(np.asarray(points,
                                                         np.float32))))


def convex_mesh_center(cm: ConvexMesh) -> Vec3:
    v = cm.verts
    n = v.x.shape[0]
    return cm.x + Vec3(v.x.mean(), v.y.mean(), v.z.mean())


def rotate_convex_mesh(cm: ConvexMesh, q) -> ConvexMesh:
    """Rotate vertices about the soup centroid (mesh.rs:213-221)."""
    c = Vec3(cm.verts.x.mean(), cm.verts.y.mean(), cm.verts.z.mean())
    return cm._replace(verts=qrotate(q, cm.verts - c) + c)


def support_convex_mesh(cm: ConvexMesh, d: Vec3) -> Vec3:
    """Linear-scan support (mesh.rs:224-235), batched over d's shape: the
    (V,) x batch dot products reduce with argmax."""
    batch = jnp.shape(d.x)
    vx = cm.verts.x.reshape((-1,) + (1,) * len(batch))
    vy = cm.verts.y.reshape((-1,) + (1,) * len(batch))
    vz = cm.verts.z.reshape((-1,) + (1,) * len(batch))
    score = vx * d.x + vy * d.y + vz * d.z          # (V, *batch)
    best = jnp.argmax(score, axis=0)
    pick = lambda comp: jnp.take(comp, best, axis=0)
    return Vec3(pick(cm.verts.x), pick(cm.verts.y), pick(cm.verts.z)) + cm.x
