"""Parity tests for the fused solver-sweep kernel (ops/solver_sweep.py)
against the jnp ``solve_rows`` path, plus the jnp solve's own invariants.

The kernel implements the single-phase textbook-friction ISO path of
``solve_rows`` (solver.rs:220-240 impulse math with scalar isotropic
world inverse inertia): identical operations in the same order, so the
two paths must agree to float addition-order noise.  It compiles through
Triton for the GPU; here it runs in the Pallas interpreter
(``pallas_interpret=True``) — the math is the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgf_tpu.checks import random_row_system
from mgf_tpu.math3d import Mat3, Vec3
from mgf_tpu.solver import solve_rows


def _random_rows(n=700, R=6, seed=0, valid_frac=0.7):
    return random_row_system(n, R, seed, valid_frac)


def _run(rc, v, omega, inv_mass, iso, pallas, iters=3, inner=4, warm=None,
         ngr=None):
    return solve_rows(rc, v, omega, inv_mass, iso, iters,
                      friction_mode="textbook", two_phase=False,
                      inner_iters=inner, warm=warm, return_acc=True,
                      n_gather_rows=ngr, pallas_inner=pallas,
                      pallas_interpret=True)


def _assert_close(a, b, atol=2e-4, mask=None):
    """mask: compare only where True (the jnp path updates accumulators on
    INVALID rows too and masks at apply time, while the kernel masks the
    accumulator update itself — invalid-row accumulators are never
    consumed, so parity is defined on valid rows)."""
    for ga, gb in zip(jax.tree_util.tree_leaves(a),
                      jax.tree_util.tree_leaves(b)):
        ga, gb = np.asarray(ga), np.asarray(gb)
        if mask is not None:
            m = np.asarray(mask)
            ga, gb = ga[m], gb[m]
        np.testing.assert_allclose(ga, gb, atol=atol, rtol=1e-4)


def test_pallas_inner_sweeps_match_jnp():
    args = _random_rows()
    vj, oj, accj = _run(*args, pallas=False)
    vp, op, accp = _run(*args, pallas=True)
    _assert_close((vj, oj), (vp, op))
    _assert_close(accj, accp, mask=args[0].valid)
    # the solve must actually do something (non-degenerate fixture)
    assert float(jnp.abs(vj.x - args[1].x).max()) > 1e-3


def test_pallas_inner_sweeps_warm_started():
    rc, v, omega, inv_mass, iso = _random_rows(seed=3)
    rng = np.random.default_rng(9)
    R, n = rc.valid.shape
    warm = tuple(jnp.asarray(rng.uniform(0, 0.3, (R, n)), jnp.float32)
                 for _ in range(3))
    vj, oj, accj = _run(rc, v, omega, inv_mass, iso, pallas=False,
                        warm=warm)
    vp, op, accp = _run(rc, v, omega, inv_mass, iso, pallas=True, warm=warm)
    _assert_close((vj, oj), (vp, op))
    _assert_close(accj, accp, mask=rc.valid)


def _static_tail(seed=5):
    """Trailing rows point at the terminal static body row, which has
    genuinely zero velocity (so cutting them from the gather is exact)."""
    rc, v, omega, inv_mass, iso = _random_rows(seed=seed)
    R, n = rc.valid.shape
    ngr = R - 2
    static_partner = jnp.full((2, n), n, jnp.int32)
    rc = rc._replace(partner=jnp.concatenate(
        [rc.partner[:ngr], static_partner], axis=0))
    v = Vec3(v.x.at[n].set(0.0), v.y.at[n].set(0.0), v.z.at[n].set(0.0))
    omega = Vec3(omega.x.at[n].set(0.0), omega.y.at[n].set(0.0),
                 omega.z.at[n].set(0.0))
    return (rc, v, omega, inv_mass, iso), ngr


def test_pallas_inner_sweeps_static_tail_rows():
    """n_gather_rows: trailing rows have a STATIC partner whose term is
    identically zero — both paths must cut them from the state gather and
    still agree."""
    args, ngr = _static_tail()
    vj, oj, _ = _run(*args, pallas=False, ngr=ngr)
    vp, op, _ = _run(*args, pallas=True, ngr=ngr)
    _assert_close((vj, oj), (vp, op))


def test_n_gather_rows_cut_matches_uncut():
    """The jnp solve with the static tail cut from the per-sweep gather
    equals the uncut gather."""
    args, ngr = _static_tail(seed=6)
    vj, oj, _ = _run(*args, pallas=False, ngr=ngr)
    vf, of, _ = _run(*args, pallas=False, ngr=None)
    _assert_close((vj, oj), (vf, of))


def test_pallas_rejects_unsupported_modes():
    rc, v, omega, inv_mass, iso = _random_rows(n=64, R=2)
    with pytest.raises(ValueError):
        solve_rows(rc, v, omega, inv_mass, iso, 2, two_phase=True,
                   pallas_inner=True)


def test_pallas_kernel_refuses_cpu_without_interpret():
    """The kernel compiles for the GPU only: on the CPU it raises unless
    the caller asks for the interpreter — it never picks interpret mode
    from the backend."""
    rc, v, omega, inv_mass, iso = _random_rows(n=64, R=2)
    with pytest.raises(RuntimeError, match="GPU only"):
        solve_rows(rc, v, omega, inv_mass, iso, 2, two_phase=False,
                   pallas_inner=True)


def test_iso_scalar_inertia_matches_mat3_diagonal():
    """The iso fast path (scalar world inverse inertia) equals the Mat3
    path with the same inertia on the diagonal."""
    rc, v, omega, inv_mass, iso = _random_rows(n=300, seed=11)
    z = jnp.zeros_like(iso)
    mat = Mat3(iso, z, z, z, iso, z, z, z, iso)
    for two_phase in (False, True):
        a = solve_rows(rc, v, omega, inv_mass, iso, 3, two_phase=two_phase,
                       inner_iters=2)
        b = solve_rows(rc, v, omega, inv_mass, mat, 3, two_phase=two_phase,
                       inner_iters=2)
        _assert_close(a, b, atol=1e-5)


def test_warm_start_from_zero_equals_cold():
    """A warm start from all-zero accumulators is exactly a cold solve."""
    rc, v, omega, inv_mass, iso = _random_rows(n=300, seed=12)
    z = jnp.zeros(rc.valid.shape, jnp.float32)
    cold = _run(rc, v, omega, inv_mass, iso, pallas=False)
    warm = _run(rc, v, omega, inv_mass, iso, pallas=False, warm=(z, z, z))
    for a, b in zip(jax.tree_util.tree_leaves(cold),
                    jax.tree_util.tree_leaves(warm)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
