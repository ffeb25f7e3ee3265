"""Checkpoint / resume.

The reference serializes shapes, meshes, Pools and BVHs with serde
(CHANGELOG v1.2.4/1.2.5; e.g. geom.rs:31, mesh.rs:31, bvh.rs:29) but
notably NOT RigidBodyVec.  Here the whole :class:`~mgf_tpu.world.World` is
one pytree, so checkpointing is a flat array save/load — strictly more
capable than the reference (full simulation state round-trips).

``save_world``/``load_world`` use numpy ``.npz`` (no external deps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _flatten_with_paths(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        key = "/".join(str(p.name) if hasattr(p, 'name') else str(p.idx)
                       for p in path)
        out[key] = np.asarray(leaf)
    return out, treedef


def save_world(path: str, world):
    """Serialize a World (or any pytree of arrays) to ``path``."""
    arrays, _ = _flatten_with_paths(world)
    np.savez_compressed(path, **arrays)


def load_world(path: str, like):
    """Load a pytree saved by :func:`save_world` into the structure of
    ``like`` (a template World with matching shapes)."""
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")
    arrays, treedef = _flatten_with_paths(like)
    leaves = []
    flat, _ = jax.tree_util.tree_flatten_with_path(like)
    for path_, leaf in flat:
        key = "/".join(str(p.name) if hasattr(p, 'name') else str(p.idx)
                       for p in path_)
        leaves.append(jnp.asarray(data[key]))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like), leaves)
