"""Eigenmode convergence tests — the primary correctness oracle.

Rebuild of the reference's tests/eigenmode acceptance tests (SURVEY.md §6):
analytic plane-wave eigenmodes on periodic boxes, L2 error at final time,
observed convergence orders.  Binding bar per BASELINE.json: 2nd/4th-order
temporal convergence verified, spatial error converging at the expected
order per degree.

Temporal order is measured against a same-mesh fine-dt reference solution so
the spatial discretization error cancels exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PlaneWave,
    State,
    cfl_dt,
    convergence_order,
    interpolate,
    l2_error,
    run,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _run_case(dm, pw, T, order, cfl=0.4, dt=None):
    p = build_params(dm, MAT, dtype=jnp.float64)
    if dt is None:
        dt = cfl_dt(dm.h.min(), float(np.asarray(MAT.vp)), dm.re.degree, cfl)
    n_steps = max(int(np.ceil(T / dt)), 1)
    dt = T / n_steps
    u0 = interpolate(dm, pw.u, 0.0)
    s0 = interpolate(dm, pw.sigma, 0.5 * dt)
    st = State(u=jnp.asarray(u0), s=jnp.asarray(s0))
    fin, _ = jax.jit(
        lambda p, st: run(p, st, dt, n_steps, order=order)
    )(p, st)
    return fin, dt, n_steps, p


# Expected spatial orders observed for central-flux nodal DG + LF4 on this
# mesh family (validated at build time; central flux is suboptimal for odd
# degrees — the reference's flux choice behaves the same way, SURVEY.md §4.2).
SPATIAL_MIN_ORDER = {1: 1.4, 2: 2.8, 3: 3.0, 4: 4.2}


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_eigenmode2d_spatial_convergence(degree):
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    T = pw.period
    Ns = {1: [8, 16, 32], 2: [4, 8, 16], 3: [2, 4, 8]}[degree]
    errs, hs = [], []
    for N in Ns:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), degree)
        fin, dt, n_steps, _ = _run_case(dm, pw, T, order=4)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
        hs.append(1.0 / N)
    order = convergence_order(hs, errs)
    assert order > SPATIAL_MIN_ORDER[degree], (order, errs)
    # error must actually shrink substantially across the sweep
    assert errs[-1] < 0.2 * errs[0]


def test_eigenmode2d_p_wave():
    """P-wave mode exercises the lambda terms (divergence coupling)."""
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 0.0]), mode="P")
    T = pw.period
    errs = []
    for N in [4, 8]:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), 3)
        fin, dt, n_steps, _ = _run_case(dm, pw, T, order=4)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
    assert errs[1] < errs[0] / 6.0


@pytest.mark.parametrize("order,expected", [(2, 2.0), (4, 4.0)])
def test_temporal_convergence(order, expected):
    """LF2 is 2nd order, LF4 is 4th order in dt (binding bar per [D]).

    Measured against a same-mesh fine-dt reference so spatial error cancels.
    """
    from seigen_jax.solver.timestep import staggered_init

    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 0.0]), mode="S")
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    T = 0.25 * pw.period
    dt0 = cfl_dt(dm.h.min(), 2.0, 2, 0.9)
    n0 = int(np.ceil(T / dt0))
    u0 = jnp.asarray(interpolate(dm, pw.u, 0.0))
    s0 = jnp.asarray(interpolate(dm, pw.sigma, 0.0))

    def final_u(n_steps):
        dt = T / n_steps
        st = staggered_init(p, u0, s0, dt, order=order)
        fin, _ = jax.jit(
            lambda p, st: run(p, st, dt, n_steps, order=order)
        )(p, st)
        return np.asarray(fin.u)

    ref = final_u(n0 * 16)
    errs = []
    for mult in [1, 2, 4]:
        diff = final_u(n0 * mult) - ref
        errs.append(float(np.sqrt((diff**2).sum())))
    r1 = np.log2(errs[0] / errs[1])
    r2 = np.log2(errs[1] / errs[2])
    assert r1 > expected - 0.4, (errs, r1, r2)
    assert r2 > expected - 0.5, (errs, r1, r2)


# central-flux LF4 3D observed orders (full sweeps in
# results/conv3d_lf_*.json: fitted 1.54 / 2.91 / 3.96 / 4.32 over N=2..16).
# Odd degrees are suboptimal for the non-dissipative central flux (the
# reference's scheme family shares this; upwind+RK4 restores q+1 — see
# test_upwind.py 3D asserts); floors track the measured N=(4,8) pair.
SPATIAL_MIN_ORDER_3D = {1: 1.3, 2: 2.8, 3: 3.4, 4: 4.2}


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_eigenmode3d_convergence(degree):
    """3D S-wave eigenmode on a periodic cube (config 3, P1-P4)."""
    pw = PlaneWave(
        mat=MAT,
        k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
        mode="S",
        polarization=np.array([0.0, 0.0, 1.0]),
    )
    T = 0.5 * pw.period
    errs = []
    for N in [4, 8]:
        dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)), degree)
        fin, dt, n_steps, _ = _run_case(dm, pw, T, order=4)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
    assert np.log2(errs[0] / errs[1]) > SPATIAL_MIN_ORDER_3D[degree], errs


def test_energy_conservation_2d():
    """Central flux + leapfrog on a periodic box conserves energy to O(dt^2)
    fluctuation with no secular drift — the discrete analog of the
    reference's non-dissipative scheme."""
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    u0 = interpolate(dm, pw.u, 0.0)
    s0 = interpolate(dm, pw.sigma, 0.5 * dt)
    st = State(u=jnp.asarray(u0), s=jnp.asarray(s0))

    def kinetic(u):
        # int rho |u|^2 via mass matrix: sum_e detJ * u^T M_ref u
        M = dm.re.M
        return float(
            np.einsum("e,eic,ij,ejc->", dm.detJ, np.asarray(u), M, np.asarray(u))
        )

    e_hist = []
    for chunk in range(6):
        fin, _ = jax.jit(lambda p, st: run(p, st, dt, 50, order=4))(p, st)
        st = fin
        e_hist.append(kinetic(st.u))
    e_hist = np.array(e_hist)
    # kinetic energy oscillates (exchanges with strain energy) but its
    # envelope must not decay/grow: compare extremes to the first value
    assert np.all(e_hist > 0)
    assert abs(e_hist[-1] - e_hist[0]) < 0.05 * e_hist[0]


@pytest.mark.parametrize("order,cfl", [(2, 0.6), (4, 1.5)])
def test_cfl_stability_margin(order, cfl):
    """Empirical stability bound regression (results/cfl_study.json):
    LF2 is stable to cfl ~0.75-0.85, LF4 to ~2.0-2.6 in the
    dt = cfl h / (vp (2q+1)) normalization; these points must stay stable."""
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, cfl)
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    fin, _ = jax.jit(lambda p, st: run(p, st, dt, 400, order=order))(p, st)
    m = float(np.abs(np.asarray(fin.u)).max())
    assert np.isfinite(m) and m < 10.0
