"""Fixed-capacity masked slot tables.

Counterpart of the reference's container layer:

* ``Pool<T>`` (pool.rs:37-41) — a growable free-list slab with stable
  indices.  In jitted device code, growable structures don't exist; the equivalent is a
  fixed-capacity :class:`SlotTable` whose free list is a validity mask and
  whose "allocation" picks the first free slot branch-free.  The EPA
  polytope (gjk.py) and the manifold pruner (manifold.py) are built on this
  pattern inline; this module exposes it as a reusable primitive.
* ``FixedSizeBitSet`` (bitset.rs:19-31) — on device a boolean mask array IS the
  bitset; the capsule-vs-polygon routine's parallel-edge marking
  (collision.rs:901-921) uses plain bool vectors (collision.py stage 4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SlotTable(NamedTuple):
    """values: pytree with leading slot axis S; valid: (S, ...) bool."""
    values: object
    valid: jnp.ndarray


def slot_table(values, valid) -> SlotTable:
    return SlotTable(values=values, valid=valid)


def slot_insert(table: SlotTable, value, enable=True) -> SlotTable:
    """Write ``value`` into the first free slot (Pool::push, pool.rs:81-96:
    reuses freed slots before growing — here capacity is fixed and overflow
    silently drops, callers track it via :func:`slot_overflow`)."""
    free = ~table.valid
    first_free_rank = jnp.cumsum(free.astype(jnp.int32), axis=0)
    is_target = free & (first_free_rank == 1) & enable
    new_values = jax.tree_util.tree_map(
        lambda slots, v: jnp.where(
            is_target.reshape(is_target.shape + (1,) * (slots.ndim
                                                        - is_target.ndim)),
            jnp.broadcast_to(v, slots.shape), slots),
        table.values,
        jax.tree_util.tree_map(lambda v: v, value))
    return SlotTable(values=new_values, valid=table.valid | is_target)


def slot_remove(table: SlotTable, index) -> SlotTable:
    """Invalidate slot ``index`` (Pool::remove, pool.rs:100-113 — indices of
    other slots are stable)."""
    s = table.valid.shape[0]
    mask = jnp.arange(s) == index
    mask = mask.reshape(mask.shape + (1,) * (table.valid.ndim - 1))
    return table._replace(valid=table.valid & ~mask)


def slot_overflow(table: SlotTable, wanted):
    """How many inserts were dropped because the table was full."""
    return jnp.maximum(wanted - jnp.sum(table.valid, axis=0), 0)
