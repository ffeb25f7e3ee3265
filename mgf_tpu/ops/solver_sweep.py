"""Fused row-solver inner sweeps as a Pallas kernel for Hopper (Triton).

``solve_rows`` (solver.py) freezes the partner velocity term for each
OUTER iteration and runs ``inner_iters`` block-Jacobi sweeps that update
only each body's OWN velocity — so within an outer iteration the columns
(bodies) are fully independent, and the whole inner loop can run inside
one program per block of bodies.  The jnp inner loop re-reads the ~18
(R, N) constraint channels from device memory every sweep; this kernel
reads them once per outer iteration and holds them, with the sweep state
(va, oa, accumulated impulses), in registers across the sweeps (re-reading
them from L2 each sweep measured slower; PERF.md).

Semantics are exactly ``solve_rows``'s single-phase textbook-friction iso
path (solver.rs:220-240 impulse math; scalar isotropic world inverse
inertia — the spheres fast path): same operations in the same order, so
results agree with the jnp path to float addition-order noise.

Channel layout of the packed (18, R, N) constraint tensor (see
pack_row_fields): normal(3) t1(3) t2(3) ra(3), then friction, bias,
normal_mass, tangent_mass1, tangent_mass2, valid.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# bodies per program (a power of two: Triton block sizes; 32 measured
# fastest of 32/64 on the H100, PERF.md) and warps per program
BLOCK = 32
NUM_WARPS = 4

_NCH = 18


def row_pad(R: int) -> int:
    """Rows padded to the next power of two (Triton block shapes)."""
    return 1 << max(int(R) - 1, 0).bit_length()


def pack_row_fields(rc) -> jnp.ndarray:
    """Stack the RowConstraints channels the sweep reads into one
    (18, R, N) f32 tensor (built once per step)."""
    v = rc.valid.astype(jnp.float32)
    return jnp.stack([
        rc.normal.x, rc.normal.y, rc.normal.z,
        rc.t1.x, rc.t1.y, rc.t1.z,
        rc.t2.x, rc.t2.y, rc.t2.z,
        rc.ra.x, rc.ra.y, rc.ra.z,
        rc.friction, rc.bias, rc.normal_mass,
        rc.tangent_mass1, rc.tangent_mass2, v,
    ], axis=0)


def _kernel(fields_ref, term_ref, self_ref, s_in_ref, acc_in_ref,
            s_out_ref, acc_out_ref, *, inner_iters: int):
    f = [fields_ref[c] for c in range(_NCH)]            # each (R, B)
    tx, ty, tz = term_ref[0], term_ref[1], term_ref[2]  # frozen partner term
    ima, ia_s = self_ref[0], self_ref[1]                # (B,)

    def sweep(_, carry):
        (nx, ny, nz, t1x, t1y, t1z, t2x, t2y, t2z, rax, ray, raz,
         fric, bias, nm, tm1, tm2, valid) = f
        vax, vay, vaz, oax, oay, oaz, acc_n, acc_t1, acc_t2 = carry
        # dv = frozen partner term - (va + oa x ra), (B,) -> (R, B)
        dvx = tx - (vax[None, :] + oay[None, :] * raz - oaz[None, :] * ray)
        dvy = ty - (vay[None, :] + oaz[None, :] * rax - oax[None, :] * raz)
        dvz = tz - (vaz[None, :] + oax[None, :] * ray - oay[None, :] * rax)
        # friction first (single-phase: both from the same dv)
        lam1 = -(dvx * t1x + dvy * t1y + dvz * t1z) * tm1
        lam2 = -(dvx * t2x + dvy * t2y + dvz * t2z) * tm2
        max_l = fric * acc_n
        new1 = jnp.minimum(jnp.maximum(acc_t1 + lam1, -max_l), max_l)
        new2 = jnp.minimum(jnp.maximum(acc_t2 + lam2, -max_l), max_l)
        f1 = new1 - acc_t1
        f2 = new2 - acc_t2
        # projected normal impulse from the same dv
        vn = dvx * nx + dvy * ny + dvz * nz
        lam = nm * (bias - vn)
        new_n = jnp.maximum(acc_n + lam, 0.0)
        fn = new_n - acc_n
        # composite impulse, masked by row validity
        ix = (t1x * f1 + t2x * f2 + nx * fn) * valid
        iy = (t1y * f1 + t2y * f2 + ny * fn) * valid
        iz = (t1z * f1 + t2z * f2 + nz * fn) * valid
        # self body receives -impulse (side a); reduce over rows
        linx = -jnp.sum(ix, axis=0) * ima
        liny = -jnp.sum(iy, axis=0) * ima
        linz = -jnp.sum(iz, axis=0) * ima
        angx = -jnp.sum(ray * iz - raz * iy, axis=0) * ia_s
        angy = -jnp.sum(raz * ix - rax * iz, axis=0) * ia_s
        angz = -jnp.sum(rax * iy - ray * ix, axis=0) * ia_s
        ok = valid > 0.0
        return (vax + linx, vay + liny, vaz + linz,
                oax + angx, oay + angy, oaz + angz,
                jnp.where(ok, new_n, acc_n),
                jnp.where(ok, new1, acc_t1),
                jnp.where(ok, new2, acc_t2))

    init = tuple(s_in_ref[k] for k in range(6)) + tuple(
        acc_in_ref[k] for k in range(3))
    out = jax.lax.fori_loop(0, inner_iters, sweep, init)
    for k in range(6):
        s_out_ref[k] = out[k]
    for k in range(6, 8):
        s_out_ref[k] = s_in_ref[k]
    for k in range(3):
        acc_out_ref[k] = out[6 + k]


def inner_sweeps(S, fields, term, self_p, acc, inner_iters: int,
                 interpret: bool = False):
    """Run ``inner_iters`` fused block-Jacobi inner sweeps.

    S        (8, N)  packed body state (rows vx vy vz ox oy oz _ _)
    fields   (18, R, N) from :func:`pack_row_fields`
    term     (3, R, N) frozen partner term (vb + ob x rb)
    self_p   (2, N)  [inv_mass, iso inverse inertia]
    acc      (3, R, N) accumulated impulses (n, t1, t2)

    Returns (S', acc').  R must be a power of two and N a multiple of
    ``BLOCK`` (callers pad; padded rows and columns must have valid = 0).
    Compiles through Triton for the GPU; ``interpret=True`` runs the
    Pallas interpreter instead (CPU tests).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "inner_sweeps compiles for the GPU only; pass interpret=True "
            f"to run it on the {jax.default_backend()!r} backend")
    n = S.shape[1]
    R = fields.shape[1]
    assert n % BLOCK == 0, (n, BLOCK)
    assert R == row_pad(R), R
    bs = lambda c: pl.BlockSpec((c, R, BLOCK), lambda i: (0, 0, i))
    bv = lambda c: pl.BlockSpec((c, BLOCK), lambda i: (0, i))
    return pl.pallas_call(
        functools.partial(_kernel, inner_iters=inner_iters),
        grid=(n // BLOCK,),
        in_specs=[bs(_NCH), bs(3), bv(2), bv(8), bs(3)],
        out_specs=[bv(8), bs(3)],
        out_shape=[
            jax.ShapeDtypeStruct((8, n), jnp.float32),
            jax.ShapeDtypeStruct((3, R, n), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="solver_inner_sweeps",
    )(fields, term, self_p, S, acc)
