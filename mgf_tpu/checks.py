"""Whole-path checks, run on the card by ``chip_smoke.py`` and by the
``gpu``-marked tests, and on the CPU by the tier-1 tests where they fit.

Each check drives the engine through its normal entry points on JAX's
default device, returns what it measured, and raises ``CheckFailed`` when
a bound is violated.  None of them catches an exception and carries on.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np


class CheckFailed(AssertionError):
    """A measured value broke its bound."""


# contact-stream bounds of the balls parity check (measured on the CPU:
# miss 0/1714, dt 4.0e-5, dn 6e-8, dp 8.3e-7; bounds ~2x measured)
ORACLE_BOUNDS = {"miss": 0, "dt": 1e-4, "dn": 2e-7, "dp": 2e-6}


# ---------------------------------------------------------------------------
# contact-stream diff against the f64 oracle
# ---------------------------------------------------------------------------

def _contact_dict(idx_a, idx_b, contact):
    """(a, b, slot) -> (t, n, a, b) dict over ALL contact slots, with
    everything pulled to numpy in one transfer per field."""
    ia = np.asarray(idx_a)
    ib = np.asarray(idx_b)
    out = {}
    S = contact.valid.shape[0]
    for s in range(S):
        c = jax.tree_util.tree_map(lambda x: np.asarray(x[s]), contact)
        nn = np.stack([c.n.x, c.n.y, c.n.z], -1)
        aa = np.stack([c.a.x, c.a.y, c.a.z], -1)
        bb = np.stack([c.b.x, c.b.y, c.b.z], -1)
        for k in np.nonzero(c.valid)[0]:
            out[(int(ia[k]), int(ib[k]), s)] = (float(c.t[k]), nn[k],
                                                aa[k], bb[k])
    return out


def _pair_set(m):
    """The rows form emits each pair twice ((i,j) and its mirror (j,i));
    canonicalize to the oracle's receiver-has-larger-index orientation."""
    raw = _contact_dict(m["pair_contacts"]["i"], m["pair_contacts"]["j"],
                        m["pair_contacts"]["contact"])
    out = {}
    for (i, j, s), (t, n, a, b) in raw.items():
        if i > j:
            out[(i, j, s)] = (t, n, a, b)
        elif (j, i, s) not in out:
            out[(j, i, s)] = (t, -n, b, a)
    return out


def _terrain_set(m):
    return _contact_dict(m["terrain_contacts"]["i"],
                         m["terrain_contacts"]["tri"],
                         m["terrain_contacts"]["contact"])


def _oracle_sets(rec):
    pairs, terr = {}, {}
    for k in range(len(rec["kind"])):
        val = (float(rec["t"][k]), rec["n"][k], rec["pa"][k], rec["pb"][k])
        if rec["kind"][k] == 0:
            # terrain j encodes tri * 2 + slot (capsules emit two slots)
            j = int(rec["j"][k])
            terr[(int(rec["i"][k]), j >> 1, j & 1)] = val
        else:
            # pair slot: 0 except capsule-pair "ends" second endpoints
            s = int(rec["slot"][k]) if "slot" in rec else 0
            pairs[(int(rec["i"][k]), int(rec["j"][k]), s)] = val
    return pairs, terr


def diff_streams(m, rec, worst):
    """Fold one step's engine contacts (``m`` from a
    ``collect_contacts=True`` step) vs the oracle's record into ``worst``
    (keys miss, total, dt, dn, dp)."""
    jp = _pair_set(m)
    jt = _terrain_set(m)
    op, ot = _oracle_sets(rec)
    for (jax_side, oracle_side) in ((jp, op), (jt, ot)):
        common = jax_side.keys() & oracle_side.keys()
        sym = (jax_side.keys() | oracle_side.keys()) - common
        worst["miss"] += len(sym)
        worst["total"] += max(len(jax_side), len(oracle_side), 1)
        for key in common:
            tj, nj, aj, bj = jax_side[key]
            to, no, ao, bo = oracle_side[key]
            worst["dt"] = max(worst["dt"], abs(tj - to))
            worst["dn"] = max(worst["dn"], float(np.abs(nj - no).max()))
            worst["dp"] = max(worst["dp"],
                              float(np.abs(aj - ao).max()),
                              float(np.abs(bj - bo).max()))
    return worst


def count_matmuls(fn, *args):
    """(dot_general/conv count, how many of them below HIGHEST precision)
    in the jaxpr of ``fn(*args)`` — on the GPU an f32 product below
    HIGHEST may run in TF32."""
    total = low = 0

    def walk(jaxpr):
        nonlocal total, low
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
                total += 1
                prec = eqn.params.get("precision")
                p = prec[0] if isinstance(prec, tuple) else prec
                if p != jax.lax.Precision.HIGHEST:
                    low += 1
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return total, low


def oracle_contact_parity(steps: int = 90):
    """Per-step contact-stream parity of the production rows path (grid
    broadphase, jitted on the default device) against the f64 oracle on
    the 217-body balls scene.  The oracle advances the trajectory; each
    step its state is pushed into the f32 step and the two contact
    streams are diffed contact for contact.  Returns (worst, dvs,
    matmuls): the stream bounds' inputs, the per-step max |dv_y| (the
    rows-Jacobi vs sequential-GS schedule divergence), and
    :func:`count_matmuls` of the step."""
    from mgf_tpu import oracle
    from mgf_tpu.scenes import balls_scene
    from mgf_tpu.world import step

    world, cfg = balls_scene(num=6, with_dropped=True)   # 217 bodies
    fn = functools.partial(step, cfg=cfg, collect_contacts=True)
    matmuls = count_matmuls(fn, world)
    f = jax.jit(fn)
    ow = oracle.from_world(world)
    # free-fall is contact-free; advance the oracle alone to the landing
    # window
    for _ in range(60):
        ow, _ = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                   mgf_friction=True)
    worst = dict(dt=0.0, dn=0.0, dp=0.0, miss=0, total=0)
    dvs = []
    for _ in range(steps):
        w_in = oracle.to_world(ow, world)
        w, m = f(w_in)
        ow, rec = oracle.oracle_step(ow, dt=cfg.dt, iters=cfg.solver_iters,
                                     mgf_friction=True)
        worst = diff_streams(m, rec, worst)
        dvs.append(float(np.abs(np.asarray(w.bodies.v.y)
                                - ow.v[:, 1]).max()))
    return worst, np.asarray(dvs), matmuls


def check_oracle_bounds(worst):
    for key, bound in ORACLE_BOUNDS.items():
        if worst[key] > bound:
            raise CheckFailed(f"oracle parity: {key} = {worst[key]!r} > "
                              f"{bound!r} ({worst})")


# ---------------------------------------------------------------------------
# stress scene through the chunked driver
# ---------------------------------------------------------------------------

def _peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def stress_run(n_bodies: int = 100_000, mixed: bool = False,
               chunks: int = 8, chunk: int = 64, cfg_update: dict = None):
    """Step ``stress_scene(n_bodies, mixed)`` from its initial block for
    ``chunks`` chunks of ``chunk`` steps through
    ``driver.AdaptiveChunkStepper(cfg, chunk, light=True)`` — the
    headline's path.  Both schedules are compiled (and run once on the
    initial block, results discarded) before the window; each chunk is
    timed to ``block_until_ready``.

    Raises CheckFailed on a NaN, a broadphase overflow, a cache drift
    excess, or a body whose centre left the box (beyond the walls by more
    than 1 in x or z, or below y = -1)."""
    from mgf_tpu.driver import AdaptiveChunkStepper
    from mgf_tpu.scenes import stress_scene

    world, cfg = stress_scene(n_bodies, mixed=mixed)
    if cfg_update:
        cfg = cfg._replace(**cfg_update)
    wall = float(np.max(np.abs(np.asarray(world.terrain.a.x))))
    stepper = AdaptiveChunkStepper(cfg, chunk=chunk, light=True)
    t0 = time.perf_counter()
    for f in (stepper.full, stepper.hot):
        jax.block_until_ready(f(world))
    compile_s = time.perf_counter() - t0
    n_compiled = stepper.full._cache_size() + stepper.hot._cache_size()

    times, hot = [], []
    w = world
    for _ in range(chunks):
        hot.append(stepper.hot_on)
        t = time.perf_counter()
        w, m = stepper.step_chunk(w)
        jax.block_until_ready((w, m))
        times.append(time.perf_counter() - t)
        guard = _guard(w, m, wall)
    recompiles = (stepper.full._cache_size() + stepper.hot._cache_size()
                  - n_compiled)
    rates = chunk / np.asarray(times)
    return dict(guard, bodies=n_bodies, mixed=mixed, chunk=chunk,
                chunks=chunks, compile_s=compile_s,
                steps_per_s=float(np.median(rates)),
                steps_per_s_min=float(rates.min()),
                steps_per_s_max=float(rates.max()),
                hot_chunks=int(sum(hot)), recompiles=int(recompiles),
                peak_bytes=_peak_bytes(), wall=wall)


def _guard(w, m, wall):
    last = {k: np.asarray(v)[-1] for k, v in m.items()
            if k in ("num_contacts", "broadphase_overflow", "max_penetration",
                     "broadphase_cache_drift_excess")}
    b = w.bodies
    x, y, z = (np.asarray(b.x.x), np.asarray(b.x.y), np.asarray(b.x.z))
    v = np.stack([np.asarray(b.v.x), np.asarray(b.v.y), np.asarray(b.v.z)])
    out = dict(num_contacts=int(last["num_contacts"]),
               broadphase_overflow=int(last["broadphase_overflow"]),
               max_penetration=float(last["max_penetration"]),
               drift_excess=float(last["broadphase_cache_drift_excess"]),
               escaped=int(np.sum((np.abs(x) > wall + 1.0)
                                  | (np.abs(z) > wall + 1.0) | (y < -1.0))),
               nan=bool(np.isnan(x).any() or np.isnan(y).any()
                        or np.isnan(z).any() or np.isnan(v).any()
                        or np.isnan(last["max_penetration"])))
    if out["nan"]:
        raise CheckFailed(f"NaN in the stress scene state ({out})")
    if out["broadphase_overflow"] > 0:
        raise CheckFailed(f"broadphase overflow ({out})")
    if out["drift_excess"] > 0.0:
        raise CheckFailed(f"broadphase cache drift excess ({out})")
    if out["escaped"] > 0:
        raise CheckFailed(f"{out['escaped']} bodies left the box ({out})")
    return out


# ---------------------------------------------------------------------------
# fused solver-sweep kernel vs the jnp solve
# ---------------------------------------------------------------------------

KERNEL_TOL = {"atol": 2e-4, "rtol": 1e-4}


def random_row_system(n=700, R=6, seed=0, valid_frac=0.7, mass_scale=1.0):
    """A random (but self-consistent) row-constraint system: every column
    is a body, partner indices point at other bodies (M = n + 1 with a
    static terminal row), normals are unit, tangents orthonormal.
    ``mass_scale`` multiplies the effective masses (the role mass
    splitting plays in a real system: at 1.0 the sweeps diverge).
    Returns (rc, v, omega, inv_mass, iso)."""
    from mgf_tpu.math3d import Vec3
    from mgf_tpu.solver import RowConstraints

    rng = np.random.default_rng(seed)
    f32 = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)

    def unit(v):
        m = jnp.sqrt(v.x ** 2 + v.y ** 2 + v.z ** 2) + 1e-9
        return Vec3(v.x / m, v.y / m, v.z / m)

    nrm = unit(Vec3(f32(R, n), f32(R, n), f32(R, n)))
    helper = Vec3(jnp.ones((R, n), jnp.float32),
                  jnp.zeros((R, n), jnp.float32) + 0.1,
                  jnp.zeros((R, n), jnp.float32) - 0.2)
    t1 = unit(Vec3(nrm.y * helper.z - nrm.z * helper.y,
                   nrm.z * helper.x - nrm.x * helper.z,
                   nrm.x * helper.y - nrm.y * helper.x))
    t2 = Vec3(nrm.y * t1.z - nrm.z * t1.y,
              nrm.z * t1.x - nrm.x * t1.z,
              nrm.x * t1.y - nrm.y * t1.x)
    u = lambda lo, hi: jnp.asarray(rng.uniform(lo, hi, (R, n)), jnp.float32)
    rc = RowConstraints(
        partner=jnp.asarray(rng.integers(0, n + 1, (R, n)), jnp.int32),
        ra=Vec3(f32(R, n) * 0.4, f32(R, n) * 0.4, f32(R, n) * 0.4),
        rb=Vec3(f32(R, n) * 0.4, f32(R, n) * 0.4, f32(R, n) * 0.4),
        normal=nrm, t1=t1, t2=t2,
        friction=u(0.2, 0.8), bias=u(-0.5, 1.5),
        normal_mass=u(0.2, 1.0) * mass_scale,
        tangent_mass1=u(0.2, 1.0) * mass_scale,
        tangent_mass2=u(0.2, 1.0) * mass_scale,
        valid=jnp.asarray(rng.uniform(size=(R, n)) < valid_frac))
    m = n + 1
    v = Vec3(f32(m), f32(m), f32(m))
    omega = Vec3(f32(m) * 0.3, f32(m) * 0.3, f32(m) * 0.3)
    inv_mass = jnp.asarray(rng.uniform(0.5, 1.5, m), jnp.float32)
    iso = jnp.asarray(rng.uniform(0.5, 2.0, m), jnp.float32)
    return rc, v, omega, inv_mass, iso


def solver_kernel_parity(n=100_000, R=12, iters=2, inner=6, seed=0):
    """The fused inner-sweep kernel vs the jnp ``solve_rows`` at the
    headline's widths (R rows, n bodies, the settled iters x inner
    schedule, warm-started).  Returns the worst |diff| and the worst
    |diff| / (atol + rtol |ref|) (<= 1 passes); accumulators are compared
    on valid rows only."""
    from mgf_tpu.solver import solve_rows

    rc, v, omega, inv_mass, iso = random_row_system(n, R, seed,
                                                    mass_scale=3.0 / R)
    rng = np.random.default_rng(seed + 1)
    warm = tuple(jnp.asarray(rng.uniform(0, 0.3, (R, n)), jnp.float32)
                 for _ in range(3))

    def run(pallas):
        f = jax.jit(lambda rc, v, o, w: solve_rows(
            rc, v, o, inv_mass, iso, iters, friction_mode="textbook",
            two_phase=False, inner_iters=inner, warm=w, return_acc=True,
            pallas_inner=pallas))
        return jax.block_until_ready(f(rc, v, omega, warm))

    vj, oj, accj = run(False)
    vp, op, accp = run(True)
    valid = np.asarray(rc.valid)
    worst_abs = worst_ratio = 0.0
    pairs = list(zip(jax.tree_util.tree_leaves((vj, oj)),
                     jax.tree_util.tree_leaves((vp, op))))
    pairs += [(a[valid], b[valid]) for a, b in
              zip(map(np.asarray, accj), map(np.asarray, accp))]
    for ref, got in pairs:
        ref, got = np.asarray(ref), np.asarray(got)
        d = np.abs(got - ref)
        worst_abs = max(worst_abs, float(d.max()))
        worst_ratio = max(worst_ratio, float(
            (d / (KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * np.abs(ref)))
            .max()))
    moved = float(jnp.abs(vj.x - v.x).max())
    out = dict(worst_abs=worst_abs, worst_ratio=worst_ratio, moved=moved)
    if not worst_ratio <= 1.0 or moved < 1e-3:
        raise CheckFailed(f"solver kernel parity ({out})")
    return out


# ---------------------------------------------------------------------------
# spatial multi-device step vs the one-device step
# ---------------------------------------------------------------------------

def spatial_vs_single(n_devices: int = 4, n_bodies: int = 100_000,
                      halo: int = 4096, steps: int = 8, atol: float = 5e-3,
                      cfg_update: dict = None):
    """``parallel.spatial.make_spatial_step`` over ``n_devices`` devices
    vs the one-device ``world.step`` on the same stress scene (the pile
    dropped to just above the floor so contacts and warm rows form within
    a couple of steps), compared order-independently on sorted positions.
    Requires stray 0, halo and broadphase overflow 0, and every device to
    hold real bodies."""
    from jax.sharding import Mesh
    from mgf_tpu.parallel.spatial import (init_spatial_bp_cache,
                                          make_spatial_step,
                                          shard_world_spatial)
    from mgf_tpu.scenes import stress_scene
    from mgf_tpu.world import make_step_fn

    devs = jax.devices()
    if len(devs) < n_devices:
        raise CheckFailed(f"need {n_devices} devices, JAX sees {len(devs)}")
    world, cfg = stress_scene(n_bodies)
    if cfg_update:
        cfg = cfg._replace(**cfg_update)
    world = world._replace(bodies=world.bodies._replace(
        x=world.bodies.x._replace(y=world.bodies.x.y - 1.4)))

    fs = make_step_fn(cfg)
    ws = jax.device_put(world, devs[0])
    t0 = time.perf_counter()
    for _ in range(steps):
        ws, ms = fs(ws)
    jax.block_until_ready(ws)
    single_s = time.perf_counter() - t0

    mesh = Mesh(np.array(devs[:n_devices]), ("b",))
    wsh, bounds = shard_world_spatial(world, mesh, cfg=cfg)
    f = make_spatial_step(cfg, mesh, bounds, halo=halo,
                          halo_width=cfg.grid.cell_size)
    if cfg.bp_every > 1:
        wsh = init_spatial_bp_cache(wsh, mesh, cfg, halo=halo)
    t0 = time.perf_counter()
    worst = dict(stray=0, halo_overflow=0, broadphase_overflow=0)
    for _ in range(steps):
        wsh, msh = f(wsh)
        for k in worst:
            worst[k] = max(worst[k], int(np.asarray(msh[
                "spatial_stray" if k == "stray" else k])))
    jax.block_until_ready(wsh)
    sharded_s = time.perf_counter() - t0

    # every device must hold real bodies (pads are parked at x >= 1e5)
    per_dev = {}
    for shard in wsh.bodies.x.x.addressable_shards:
        xs = np.asarray(shard.data)
        per_dev[str(shard.device)] = int(np.sum(xs < 9e4))
    devices_used = sum(1 for c in per_dev.values() if c > 0)

    def sorted_pos(w):
        b = w.bodies
        arr = np.stack([np.asarray(b.x.x), np.asarray(b.x.y),
                        np.asarray(b.x.z)], axis=-1)
        arr = arr[arr[:, 0] < 9e4]
        return arr[np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))]

    diff = float(np.abs(sorted_pos(wsh) - sorted_pos(ws)).max())
    out = dict(worst, bodies=n_bodies, devices=n_devices, halo=halo,
               steps=steps, max_abs_diff=diff, atol=atol,
               devices_used=devices_used, bodies_per_device=per_dev,
               contacts=int(np.asarray(msh["num_contacts"])),
               contacts_single=int(np.asarray(ms["num_contacts"])),
               single_s_incl_compile=single_s,
               sharded_s_incl_compile=sharded_s)
    if (diff > atol or any(worst.values())
            or devices_used != n_devices):
        raise CheckFailed(f"spatial vs single device ({out})")
    return out
