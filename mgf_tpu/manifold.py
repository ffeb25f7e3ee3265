"""Contact pruning and manifold construction.

Counterpart of ``src/manifold.rs``: per body-pair, keep only the
contacts at the earliest time of impact (within COLLISION_EPSILON) and drop
points closer than PERSISTENT_THRESHOLD to an already-kept point, preferring
the point farther from the bodies' centers.  The reference's SmallVec becomes
MAX_CONTACTS fixed slots (leading slot axis) with validity masks; the
sequential push loop (manifold.rs:72-102) is unrolled branch-free.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mgf_tpu.collision import LocalContact
from mgf_tpu.geom import compute_basis
from mgf_tpu.math3d import (
    COLLISION_EPSILON, Vec3, magnitude2, safe_div, vzeros_like, where_vec,
)

# manifold.rs:38
PERSISTENT_THRESHOLD_SQ = 0.5
# manifold.rs:117 (SmallVec inline size; the solver consumes up to 4 points)
MAX_CONTACTS = 4


class Manifold(NamedTuple):
    """A set of contacts between two objects (manifold.rs:112-118).

    Slot fields carry a LEADING slot axis of size S (max_contacts).
    """
    time: jnp.ndarray   # (...,)
    normal: Vec3        # (...,) averaged contact normal
    t1: Vec3            # friction tangent 1
    t2: Vec3            # friction tangent 2
    local_a: Vec3       # (S, ...)
    local_b: Vec3       # (S, ...)
    valid: jnp.ndarray  # (S, ...) bool


def slot(tree, s):
    """Select slot s of a leading-slot-axis pytree."""
    return jax.tree_util.tree_map(lambda x: x[s], tree)


def prune(lc: LocalContact, max_contacts: int = MAX_CONTACTS,
          prox_sq: float = PERSISTENT_THRESHOLD_SQ) -> Manifold:
    """Build a Manifold from a leading slot axis of LocalContacts.

    Reproduces ContactPruner::push (manifold.rs:72-102) + Manifold::from
    (manifold.rs:131-148), unrolled over the incoming slots.

    ``prox_sq`` is the squared proximity-merge threshold
    (PruningParams::PERSISTENT_THRESHOLD_SQ, manifold.rs:38).  Callers
    emitting INTENTIONAL close contact pairs (the capsule flank-interval
    endpoint extension — small capsules have endpoints < sqrt(0.5) apart)
    pass a smaller threshold so the pair survives; the reference value
    stays the default."""
    S = lc.contact.t.shape[0]
    batch = lc.contact.t.shape[1:]

    inf = jnp.float32(jnp.inf)
    min_t = jnp.full(batch, inf)
    zero = Vec3(jnp.zeros(batch), jnp.zeros(batch), jnp.zeros(batch))
    kept_ga = [zero for _ in range(max_contacts)]
    kept_gb = [zero for _ in range(max_contacts)]
    kept_la = [zero for _ in range(max_contacts)]
    kept_lb = [zero for _ in range(max_contacts)]
    kept_n = [zero for _ in range(max_contacts)]
    kept_ok = [jnp.zeros(batch, bool) for _ in range(max_contacts)]

    for s in range(S):
        t = lc.contact.t[s]
        ok = lc.contact.valid[s]
        ga, gb = lc.contact.a[s], lc.contact.b[s]
        la, lb = lc.local_a[s], lc.local_b[s]
        nn = lc.contact.n[s]

        earlier = ok & (t < min_t - COLLISION_EPSILON)
        later = t > min_t + COLLISION_EPSILON
        same = ok & ~earlier & ~later

        new_dist = magnitude2(la) + magnitude2(lb)
        matched = jnp.zeros(batch, bool)
        for k in range(max_contacts):
            close = (kept_ok[k]
                     & ((magnitude2(ga - kept_ga[k]) <= prox_sq)
                        | (magnitude2(gb - kept_gb[k]) <= prox_sq)))
            hit = same & ~matched & close
            replace = hit & ((magnitude2(kept_la[k]) + magnitude2(kept_lb[k]))
                             < new_dist)
            kept_ga[k] = where_vec(replace, ga, kept_ga[k])
            kept_gb[k] = where_vec(replace, gb, kept_gb[k])
            kept_la[k] = where_vec(replace, la, kept_la[k])
            kept_lb[k] = where_vec(replace, lb, kept_lb[k])
            kept_n[k] = where_vec(replace, nn, kept_n[k])
            matched = matched | hit

        append = same & ~matched
        placed = jnp.zeros(batch, bool)
        for k in range(max_contacts):
            free = append & ~placed & ~kept_ok[k]
            kept_ga[k] = where_vec(free, ga, kept_ga[k])
            kept_gb[k] = where_vec(free, gb, kept_gb[k])
            kept_la[k] = where_vec(free, la, kept_la[k])
            kept_lb[k] = where_vec(free, lb, kept_lb[k])
            kept_n[k] = where_vec(free, nn, kept_n[k])
            kept_ok[k] = kept_ok[k] | free
            placed = placed | free

        for k in range(max_contacts):
            kept_ok[k] = jnp.where(earlier, k == 0, kept_ok[k])
            kept_ga[k] = where_vec(earlier & (k == 0), ga, kept_ga[k])
            kept_gb[k] = where_vec(earlier & (k == 0), gb, kept_gb[k])
            kept_la[k] = where_vec(earlier & (k == 0), la, kept_la[k])
            kept_lb[k] = where_vec(earlier & (k == 0), lb, kept_lb[k])
            kept_n[k] = where_vec(earlier & (k == 0), nn, kept_n[k])
        min_t = jnp.where(earlier, t, min_t)

    count = sum(k.astype(jnp.float32) for k in kept_ok)
    n_sum = zero
    for k in range(max_contacts):
        n_sum = n_sum + where_vec(kept_ok[k], kept_n[k], zero)
    avg_n = n_sum * safe_div(1.0, count)
    t1, t2 = compute_basis(avg_n)

    stack = lambda vs: jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs, axis=0), *vs)
    return Manifold(
        time=jnp.where(jnp.isfinite(min_t), min_t, 0.0),
        normal=avg_n, t1=t1, t2=t2,
        local_a=stack(kept_la),
        local_b=stack(kept_lb),
        valid=jnp.stack(kept_ok, axis=0),
    )


def manifold_from_local_contact(lc: LocalContact) -> Manifold:
    """Manifold::from(LocalContact) (manifold.rs:120-129) — single point."""
    one = jax.tree_util.tree_map(lambda x: jnp.expand_dims(x, 0), lc)
    return prune(one, max_contacts=MAX_CONTACTS)
