"""mgf_tpu — a JAX 3D collision-detection and rigid-body physics engine.

A ground-up JAX/XLA/Pallas re-design of the capabilities of ``maplant/mgf``
(a Rust collision/physics library; its layout is surveyed in SURVEY.md):

* all vectors are Vec3 pytrees of component arrays — every vector op runs
  on contiguous (N,) arrays (``math3d``),
* shapes live in structure-of-arrays pytrees (``geom``),
* narrowphase collision tests are branch-free natively-batched kernels
  (``collision``),
* the broadphase is an on-device modular cell grid (``broadphase``),
* rigid bodies are one SoA pytree integrated on device (``physics``),
* contacts are resolved by a fixed-iteration impulse solver (``solver``),
* a whole physics step is one jitted function (``world``),
* multi-chip scaling shards bodies over a device mesh (``parallel``).

Reference parity: each public function cites the mgf item (file:line) whose
behaviour it reproduces.
"""

from mgf_tpu import math3d
from mgf_tpu.math3d import COLLISION_EPSILON, Mat3, Quat, Vec3, vec3
from mgf_tpu.geom import (
    Plane, Ray, Segment, Triangle, Tetrahedron, Rectangle, AABB, OBB, Sphere,
    Capsule, Moving, compute_basis, closest_pts_seg,
)
from mgf_tpu import geom
from mgf_tpu import bounds
from mgf_tpu import collision
from mgf_tpu.collision import Contact, LocalContact, Intersection
from mgf_tpu import gjk
from mgf_tpu import manifold
from mgf_tpu import physics
from mgf_tpu import solver
from mgf_tpu import broadphase
from mgf_tpu import mesh
from mgf_tpu import compound
from mgf_tpu import queries
from mgf_tpu import world
from mgf_tpu import scenes

__version__ = "0.2.0"
