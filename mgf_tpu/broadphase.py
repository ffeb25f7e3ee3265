"""Broadphase collision culling on device.

The reference uses an incremental SAH-balanced AABB tree with fat proxies
(src/bvh.rs + mgf_demo/world.rs:233-238).  Pointer trees and per-object
insert/remove do not map to batched device code, so this module replaces them with a
*modular cell grid* rebuilt every step:

1. bodies are binned by swept-AABB center into cells of side ``cell_size``,
   addressed modulo a power-of-two grid dimension — a dense
   ``(dim^3, bucket_cap)`` table.  Neighbor offsets are < 3 cells apart, so
   distinct neighbor cells always land in distinct buckets and candidate
   lists contain no duplicates by construction;
2. building the table is a sort + rank + scatter (O(N log N) on device);
3. candidates for a body are the bucket contents of its 27 neighbor cells —
   a dense (N, 27*bucket_cap) gather, masked by a swept-AABB overlap test
   (replacing BVH::query, bvh.rs:283-342);
4. ``refine_pairs`` top-k-selects the closest candidates into a fixed
   (N, max_pairs) partner list consumed by narrowphase/solver.

Cells aliasing across the modulus only *add* candidates (killed by the AABB
test) or overflow buckets (counted, reported in step metrics).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mgf_tpu.geom import AABB
from mgf_tpu.math3d import Vec3, magnitude2, vmax, vmin, vsplat


class GridConfig(NamedTuple):
    """Static broadphase configuration (python scalars; jit-static).

    ``dim`` is either one power-of-two (cubic table) or a per-axis
    (dx, dy, dz) tuple of powers of two.  Each axis' modulus
    (dim_axis * cell_size) must exceed that axis' occupied span or
    distinct occupied cells alias into one bucket; flat scenes (piles on
    a floor) keep dy small — the table shrinks by dy/dx and its build
    scatter with it."""
    cell_size: float
    dim: object = 64       # int, or (dx, dy, dz) tuple — see grid_dims()
    bucket_cap: int = 4    # max bodies per bucket


def grid_dims(cfg: GridConfig):
    d = cfg.dim
    return d if isinstance(d, tuple) else (d, d, d)


def grid_ncells(cfg: GridConfig) -> int:
    dx, dy, dz = grid_dims(cfg)
    return dx * dy * dz


class GridTable(NamedTuple):
    table: jnp.ndarray      # (dim^3, bucket_cap) int32 body index or -1
    overflow: jnp.ndarray   # () int32 — bodies dropped from full buckets


def _cell_coords(centers: Vec3, cfg: GridConfig):
    f = lambda c: jnp.floor(c / cfg.cell_size).astype(jnp.int32)
    return f(centers.x), f(centers.y), f(centers.z)


def _bucket_index(cx, cy, cz, cfg: GridConfig):
    dx, dy, dz = grid_dims(cfg)  # powers of two
    return ((cx & (dx - 1)) * dy + (cy & (dy - 1))) * dz + (cz & (dz - 1))


def _bucket_ranks(sorted_h, n):
    """Rank of each element within its run of equal keys.

    Equivalent to ``arange - searchsorted(sorted_h, sorted_h)`` but built
    from a cummax instead of searchsorted (XLA can lower searchsorted to a
    while-loop)."""
    ar = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool),
                                sorted_h[1:] != sorted_h[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, ar, 0))
    return ar - run_start


def build_grid(centers: Vec3, cfg: GridConfig, valid=None) -> GridTable:
    """Bin bodies into the modular grid (replaces BVH::insert batch).

    ``valid`` (N,) bool: rows marked False are NOT inserted (and not
    counted as overflow).  Parked pad/halo rows alias into in-scene cells
    through the grid modulus and can evict real bodies from full buckets
    — callers with inert rows must mask them out here rather
    than relying on far-away positions."""
    n = centers.x.shape[0]
    cx, cy, cz = _cell_coords(centers, cfg)
    h = _bucket_index(cx, cy, cz, cfg)
    if valid is not None:
        # invalid rows hash past the table and get dropped by the scatter
        h = jnp.where(valid, h, grid_ncells(cfg))
    order = jnp.argsort(h)
    sorted_h = h[order]
    rank = _bucket_ranks(sorted_h, n)
    ok = (rank < cfg.bucket_cap) & (sorted_h < grid_ncells(cfg))
    of = (rank >= cfg.bucket_cap) & (sorted_h < grid_ncells(cfg))
    table = jnp.full((grid_ncells(cfg), cfg.bucket_cap), -1, jnp.int32)
    table = table.at[jnp.where(ok, sorted_h, grid_ncells(cfg)),
                     jnp.minimum(rank, cfg.bucket_cap - 1)].set(
        jnp.where(ok, order.astype(jnp.int32), -1), mode='drop')
    return GridTable(table=table, overflow=jnp.sum(of).astype(jnp.int32))


_OFFSETS = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


class FatGrid(NamedTuple):
    """A cell table whose buckets carry the occupants' bounds inline:
    float rows [cx cy cz r_eff idx 0 0 0] — candidate generation + AABB cull
    then needs NO per-candidate body gather (gathers cost per index;
    this trades 8x more bytes per *bucket* fetch for 8x fewer indexed
    fetches overall).

    ``width == 4`` packs [cx cy cz idx] instead and carries the occupants'
    max bound radius in ``r_max`` — HALF the fetched bytes; the cull uses
    the global radius for the partner side (exact for uniform shapes,
    conservative otherwise — top-k absorbs the over-admission)."""
    table: jnp.ndarray      # (dim^3, cap * width) float32
    overflow: jnp.ndarray
    width: int = 8
    r_max: jnp.ndarray = None


def build_fat_grid(bounds: AABB, cfg: GridConfig, width: int = 8,
                   valid=None) -> FatGrid:
    """Bin bodies with their conservative bound radius into the grid.

    ``valid`` (N,) bool masks rows out of the table entirely (see
    :func:`build_grid` — parked pad/halo rows must not occupy buckets)."""
    centers = bounds.c
    n = centers.x.shape[0]
    r_eff = jnp.maximum(bounds.r.x, jnp.maximum(bounds.r.y, bounds.r.z))
    cx, cy, cz = _cell_coords(centers, cfg)
    h = _bucket_index(cx, cy, cz, cfg)
    if valid is not None:
        h = jnp.where(valid, h, grid_ncells(cfg))
        r_eff = jnp.where(valid, r_eff, 0.0)
    order = jnp.argsort(h)
    sorted_h = h[order]
    rank = _bucket_ranks(sorted_h, n)
    in_table = sorted_h < grid_ncells(cfg)
    ok = (rank < cfg.bucket_cap) & in_table
    n_over = jnp.sum((rank >= cfg.bucket_cap) & in_table).astype(jnp.int32)
    if width == 4:
        # COMPONENT-BLOCKED bucket rows [x*cap | y*cap | z*cap | idx*cap]:
        # the reader's per-component slices are lane-contiguous (cap-wide)
        # instead of stride-4 scalar picks — the cull then runs as 8
        # (N, cap) vector ops rather than 8*cap scalar-slot rounds.
        # r4: ONE (N, 4)-row scatter into slot-major (ncell*cap, 4) then a
        # layout transpose to component-blocked — the four per-component
        # scatters were most of the build at 100k on the engine's first
        # accelerator (scatter cost is per index; the 25 MB transpose is
        # bandwidth noise).
        cap = cfg.bucket_cap
        ncell = grid_ncells(cfg)
        rows4 = jnp.stack([centers.x[order], centers.y[order],
                           centers.z[order],
                           order.astype(jnp.float32) + 0.5], axis=-1)
        empty4 = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 0.0, -1.0], jnp.float32),
            (ncell * cap, 4))
        slot = sorted_h * cap + jnp.minimum(rank, cap - 1)
        table4 = empty4.at[jnp.where(ok, slot, ncell * cap)].set(
            rows4, mode='drop')
        table = (table4.reshape(ncell, cap, 4)
                 .transpose(0, 2, 1).reshape(ncell, 4 * cap))
        return FatGrid(table=table, overflow=n_over,
                       width=width, r_max=jnp.max(r_eff))
    rows = jnp.stack([centers.x[order], centers.y[order],
                      centers.z[order],
                      r_eff[order], order.astype(jnp.float32) + 0.5,
                      jnp.zeros(n), jnp.zeros(n), jnp.zeros(n)],
                     axis=-1)
    # invalid marker: idx slot < 0.  Table rows hold the WHOLE bucket
    # (cap x width floats): one gather index fetches every occupant.
    empty = jnp.zeros((8,), jnp.float32).at[4].set(-1.0)
    table = jnp.broadcast_to(empty, (grid_ncells(cfg) * cfg.bucket_cap, width))
    slot = sorted_h * cfg.bucket_cap + jnp.minimum(rank, cfg.bucket_cap - 1)
    table = table.at[jnp.where(ok, slot, grid_ncells(cfg) * cfg.bucket_cap)]\
        .set(rows, mode='drop')
    table = table.reshape(grid_ncells(cfg), cfg.bucket_cap * width)
    return FatGrid(table=table, overflow=n_over,
                   width=width, r_max=jnp.max(r_eff))


def fat_grid_pairs(bounds: AABB, grid: FatGrid, cfg: GridConfig,
                   max_pairs: int, self_rows=None, ordered: bool = True,
                   query_centers: Vec3 = None, window: str = "27"):
    """Candidate partners per body straight from the fat grid: bucket-row
    gathers (N indices each) -> AABB cull -> top-k by center distance.
    Replaces neighbor_candidates + refine_pairs with far fewer gather
    indices (gathers cost per index).  Returns (partner
    (N, max_pairs) int32, valid).

    ``window`` selects the query neighborhood:

    * ``"27"`` — the full 3x3x3 block: covers pair reach up to cell_size.
    * ``"sel8"`` — the 2x2x2 octant nearest the query point within its
      cell (per axis: own cell + the neighbor on the side the point lies
      in).  GUARANTEED reach is only cell_size/2, so the cell must be
      sized >= 2x the maximum pair reach (sum of swept fat radii) — 3.4x
      fewer gather indices than "27" for the same coverage budget.
    """
    centers = query_centers if query_centers is not None else bounds.c
    if self_rows is None:
        self_rows = jnp.arange(centers.x.shape[0], dtype=jnp.int32)
    cx, cy, cz = _cell_coords(centers, cfg)
    sx = bounds.c.x[self_rows]
    sy = bounds.c.y[self_rows]
    sz = bounds.c.z[self_rows]
    sr = jnp.maximum(bounds.r.x, jnp.maximum(
        bounds.r.y, bounds.r.z))[self_rows]

    if window == "sel8":
        # which half of its cell is the point in, per axis?
        half = lambda p, c: jnp.where(
            p - c.astype(p.dtype) * cfg.cell_size > 0.5 * cfg.cell_size,
            jnp.int32(1), jnp.int32(-1))
        sx_o = half(centers.x, cx)
        sy_o = half(centers.y, cy)
        sz_o = half(centers.z, cz)
        offsets = [(ax, ay, az) for ax in (0, 1) for ay in (0, 1)
                   for az in (0, 1)]
    else:
        offsets = _OFFSETS

    width = grid.width
    idx_slot = 3 if width == 4 else 4
    n_bodies = centers.x.shape[0]
    # closeness + candidate index fused into ONE int32 sort key
    # (14-bit quantized distance | 17-bit body index) so the top-k output
    # IS the partner id — no (N, W) candidate matrix and no second
    # take_along gather.  Falls back to float scores past 2^17 bodies.
    use_ikey = n_bodies <= (1 << 17)
    d2_max = (3.0 * cfg.cell_size) ** 2
    inv_scale = 16383.0 / d2_max
    cands = []
    scores = []
    keys = []
    cap = cfg.bucket_cap
    for o in offsets:
        if window == "sel8":
            h = _bucket_index(cx + sx_o * o[0], cy + sy_o * o[1],
                              cz + sz_o * o[2], cfg)
        else:
            (dx, dy, dz) = o
            h = _bucket_index(cx + dx, cy + dy, cz + dz, cfg)
        bucket = grid.table[h]                   # (N, cap*width) ONE gather
        if width == 4:
            # component-blocked rows: lane-contiguous (N, cap) slices
            bx = bucket[:, 0:cap]
            by = bucket[:, cap:2 * cap]
            bz = bucket[:, 2 * cap:3 * cap]
            raw_idx = bucket[:, 3 * cap:4 * cap]
            idx = raw_idx.astype(jnp.int32)
            ddx = bx - sx[:, None]
            ddy = by - sy[:, None]
            ddz = bz - sz[:, None]
            rr = grid.r_max + sr[:, None]
            ok = ((raw_idx >= 0.0) & (jnp.abs(ddx) <= rr)
                  & (jnp.abs(ddy) <= rr) & (jnp.abs(ddz) <= rr))
            if ordered:
                ok = ok & (idx < self_rows[:, None])
            else:
                ok = ok & (idx != self_rows[:, None])
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            if use_ikey:
                q = jnp.minimum((d2 * inv_scale).astype(jnp.int32), 16383)
                keys.append(jnp.where(ok, ((16383 - q) << 17) | idx, -1))
            else:
                cands.append(jnp.where(ok, idx, -1))
                scores.append(jnp.where(ok, -d2, -jnp.inf))
            continue
        bucket = bucket.reshape(-1, cfg.bucket_cap, width)
        for s in range(cfg.bucket_cap):
            row = bucket[:, s, :]
            idx = row[:, idx_slot].astype(jnp.int32)
            ddx = row[:, 0] - sx
            ddy = row[:, 1] - sy
            ddz = row[:, 2] - sz
            rr = row[:, 3] + sr
            ok = (row[:, idx_slot] >= 0.0) & (jnp.abs(ddx) <= rr) \
                & (jnp.abs(ddy) <= rr) & (jnp.abs(ddz) <= rr)
            if ordered:
                ok = ok & (idx < self_rows)
            else:
                ok = ok & (idx != self_rows)
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            if use_ikey:
                q = jnp.minimum((d2 * inv_scale).astype(jnp.int32), 16383)
                keys.append(jnp.where(ok, ((16383 - q) << 17) | idx, -1))
            else:
                cands.append(jnp.where(ok, idx, -1))
                scores.append(jnp.where(ok, -d2, -jnp.inf))
    if use_ikey:
        if width == 4:
            keym = jnp.concatenate(keys, axis=1)    # 8 x (N, cap)
        else:
            keym = jnp.stack(keys, axis=1)          # (N, W) int32
        if keym.shape[1] <= max_pairs:
            pad = max_pairs - keym.shape[1]
            top = jnp.pad(keym, ((0, 0), (0, pad)), constant_values=-1)
        else:
            top = jax.lax.top_k(keym, max_pairs)[0]
        valid = top >= 0
        return jnp.where(valid, top & 0x1FFFF, -1), valid
    join = jnp.concatenate if width == 4 else jnp.stack
    cand = join(cands, axis=1)                      # (N, 27*cap)
    score = join(scores, axis=1)
    if cand.shape[1] <= max_pairs:
        pad = max_pairs - cand.shape[1]
        partner = jnp.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
        return partner, partner >= 0
    top, pick = jax.lax.top_k(score, max_pairs)
    partner = jnp.take_along_axis(cand, pick, axis=1)
    valid = jnp.isfinite(top)
    return jnp.where(valid, partner, -1), valid


def neighbor_candidates(centers: Vec3, table: GridTable, cfg: GridConfig):
    """(N, 27*bucket_cap) candidate partner indices (-1 = empty slot)."""
    cx, cy, cz = _cell_coords(centers, cfg)
    cols = []
    # 27 separate (N, cap) gathers.  Measured alternatives that do NOT help:
    # one fused (N, 27, cap) gather (XLA picks a layout whose downstream
    # reshape pads 128x and OOMs HBM at 100k) and a transposed-table
    # (cap, dim^3) trailing-axis gather (2x faster isolated, identical
    # in-situ once the transposes are paid).
    for (dx, dy, dz) in _OFFSETS:
        h = _bucket_index(cx + dx, cy + dy, cz + dz, cfg)
        cols.append(table.table[h])            # (N, bucket_cap)
    return jnp.concatenate(cols, axis=-1)      # (N, 27*bucket_cap)


def pack_bounds(bounds: AABB):
    """Pack AABB center + conservative cube radius into one (N, 4) array so
    candidate culling does ONE narrow gather instead of six — gather
    cost is per index, and the 4-wide row halves the gathered bytes vs an
    8-wide pack (the cube radius over-admits slightly; top-k absorbs it)."""
    r_eff = jnp.maximum(bounds.r.x, jnp.maximum(bounds.r.y, bounds.r.z))
    return jnp.stack([bounds.c.x, bounds.c.y, bounds.c.z, r_eff], axis=-1)


def refine_pairs(bounds: AABB, cand, max_pairs: int, self_rows=None,
                 ordered: bool = True, packed=None):
    """Cull candidates by swept-AABB overlap; keep the closest ``max_pairs``
    per body.

    ``bounds`` are per-body swept fat AABBs (Vec3 components of shape (N,));
    ``cand`` is the (rows, K) candidate matrix of *global* body indices.
    ``self_rows`` gives the global index of each candidate row (defaults to
    0..N-1).  With ``ordered=True`` only partners with a smaller index are
    kept — the reference's ``collider_i < i`` dedupe (world.rs:266-268);
    ``ordered=False`` keeps both directions (the symmetric row-solver form).
    Returns (partner (rows, max_pairs) int32, valid mask).
    """
    if self_rows is None:
        self_rows = jnp.arange(cand.shape[0], dtype=jnp.int32)
    safe = jnp.maximum(cand, 0)
    if packed is None:
        packed = pack_bounds(bounds)
    gb = packed[safe]                              # (rows, K, 4): ONE gather
    sb = packed[self_rows][:, None, :]             # (rows, 1, 4)

    if ordered:
        ok = (cand >= 0) & (cand < self_rows[:, None])
    else:
        ok = (cand >= 0) & (cand != self_rows[:, None])
    dx = gb[..., 0] - sb[..., 0]
    dy = gb[..., 1] - sb[..., 1]
    dz = gb[..., 2] - sb[..., 2]
    rr = gb[..., 3] + sb[..., 3]
    overlap = ((jnp.abs(dx) <= rr) & (jnp.abs(dy) <= rr)
               & (jnp.abs(dz) <= rr))
    ok = ok & overlap
    d2 = dx * dx + dy * dy + dz * dz
    score = jnp.where(ok, -d2, -jnp.inf)
    if cand.shape[1] <= max_pairs:
        pad = max_pairs - cand.shape[1]
        partner = jnp.pad(jnp.where(ok, cand, -1), ((0, 0), (0, pad)),
                          constant_values=-1)
        return partner, partner >= 0
    top, idx = jax.lax.top_k(score, max_pairs)
    partner = jnp.take_along_axis(jnp.where(ok, cand, -1), idx, axis=1)
    valid = jnp.isfinite(top)
    return jnp.where(valid, partner, -1), valid


def all_pairs_candidates(n: int):
    """O(N^2) candidate matrix for small scenes / parity tests."""
    return jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (n, n))


def swept_fat_bounds(bounds: AABB, delta: Vec3, fatten: float = 0.0) -> AABB:
    """Swept (combine start/end) + optionally fattened AABB
    (bounds.rs:60-68 + world.rs:181 ``bounds + 0.25``)."""
    lo = vmin(bounds.c - bounds.r, bounds.c + delta - bounds.r)
    hi = vmax(bounds.c + bounds.r, bounds.c + delta + bounds.r)
    c = (hi + lo) * 0.5
    r = (hi - lo) * 0.5
    return AABB(c=c, r=Vec3(r.x + fatten, r.y + fatten, r.z + fatten))
