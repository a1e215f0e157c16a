"""Upwind-flux + RK4 scheme: convergence, dissipation, absorption quality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.upwind import build_upwind_data
from seigen_jax.solver import (
    PlaneWave,
    PointSource,
    State,
    absorbing_bc_fn,
    build_sources,
    cfl_dt,
    interpolate,
    l2_error,
)
from seigen_jax.solver.rk4 import run_rk4

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


@pytest.mark.parametrize("degree,min_order", [(1, 1.7), (2, 2.7), (3, 3.6)])
def test_upwind_rk4_eigenmode_convergence(degree, min_order):
    """Upwind flux restores clean ~(q+1) orders incl. odd degrees
    (central flux is suboptimal there, SPATIAL_MIN_ORDER in
    test_eigenmode.py)."""
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    T = pw.period
    Ns = {1: [8, 16], 2: [4, 8], 3: [8, 16]}[degree]
    errs = []
    for N in Ns:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), degree)
        p = build_params(dm, MAT, dtype=jnp.float64)
        w = build_upwind_data(dm, MAT, dtype=jnp.float64)
        dt = cfl_dt(dm.h.min(), 2.0, degree, 0.4)
        n_steps = int(np.ceil(T / dt))
        dt = T / n_steps
        # co-located ICs at t=0 (no staggering with RK4)
        st = State(
            u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
            s=jnp.asarray(interpolate(dm, pw.sigma, 0.0)),
        )
        fin, _ = jax.jit(
            lambda p, w, st: run_rk4(p, w, st, dt, n_steps)
        )(p, w, st)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
    order = np.log2(errs[0] / errs[1])
    assert order > min_order, (errs, order)


@pytest.mark.parametrize("degree,min_order",
                         [(1, 1.7), (2, 2.8), (3, 3.6), (4, 4.2)])
def test_upwind_rk4_eigenmode3d_convergence(degree, min_order):
    """3D upwind+RK4 h-convergence at q+1 (-0.3) for P1-P4 ([D] config 3
    accuracy bar; full 3-point sweeps in results/conv3d_up_*.json, run via
    scripts/eigenmode3d.py --scheme upwind-rk4: fitted orders
    1.61 / 3.19 / 4.06 / 4.38, asymptotic pairs 2.03 / 3.30 / 3.74 / 5.01)."""
    from seigen_jax.mesh import box_mesh

    mat = MAT
    pw = PlaneWave(
        mat=mat,
        k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
        mode="S",
        polarization=np.array([0.0, 0.0, 1.0]),
    )
    T = 0.5 * pw.period
    errs = []
    for N in [4, 8]:
        dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)), degree)
        p = build_params(dm, mat, dtype=jnp.float64)
        w = build_upwind_data(dm, mat, dtype=jnp.float64)
        dt = cfl_dt(dm.h.min(), 2.0, degree, 0.7)
        n_steps = int(np.ceil(T / dt))
        dt = T / n_steps
        st = State(
            u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
            s=jnp.asarray(interpolate(dm, pw.sigma, 0.0)),
        )
        fin, _ = jax.jit(
            lambda p, w, st: run_rk4(p, w, st, dt, n_steps)
        )(p, w, st)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
    order = np.log2(errs[0] / errs[1])
    assert order > min_order, (errs, order)


def test_upwind_suppresses_point_source_precursors():
    """The measured central-flux pathology: a compact source radiates
    precursors faster than vp.  Upwind damps them: the wavefront at 5% peak
    must travel at <= ~1.2 vp."""
    extents = ((0.0, 2.0), (0.0, 1.0))
    topo = rect_mesh(48, 24, lx=2.0, ly=1.0)
    dm = build_discrete(
        topo, 2, bc_fn=absorbing_bc_fn(extents, free_sides=[(1, "hi")]))
    p = build_params(dm, MAT, dtype=jnp.float64)
    w = build_upwind_data(dm, MAT, dtype=jnp.float64)
    src_pos = np.array([1.0, 0.5])
    # deliberately sharp source (small radius) to excite high wavenumbers
    src = build_sources(
        dm, [PointSource(position=tuple(src_pos), f0=10.0, radius=0.03)],
        dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    t_end = 0.25
    n_steps = int(t_end / dt)
    fin, _ = jax.jit(
        lambda p, w, st: run_rk4(p, w, st, dt, n_steps, src=src)
    )(p, w, st)
    umax = np.abs(np.asarray(fin.u)).max(axis=(1, 2))
    cent = dm.coords.mean(axis=1)
    r = np.linalg.norm(cent - src_pos, axis=1)
    front = r[umax > 0.05 * umax.max()].max()
    t0 = 1.2 / 10.0
    onset = 0.05  # 2%-onset before t0
    max_physical = 2.0 * (n_steps * dt - t0 + onset) + 3 * 0.03 + dm.h.max()
    assert front <= max(1.2 * max_physical, 0.15), (front, max_physical)


def test_upwind_energy_decays():
    """Dissipative flux: energy decreases monotonically on a periodic box
    (no boundaries, no damping) for under-resolved data."""
    dm = build_discrete(rect_mesh(6, 6, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    w = build_upwind_data(dm, MAT, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    st = State(
        u=jnp.asarray(rng.normal(size=(dm.num_elements, dm.re.n_p, 2))),
        s=jnp.asarray(rng.normal(size=(dm.num_elements, dm.re.n_p, 3))),
    )
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.3)

    def energy(state):
        M = dm.re.M
        e = 0.0
        for fld in (state.u, state.s):
            a = np.asarray(fld)
            e += float(np.einsum("e,eic,ij,ejc->", dm.detJ, a, M, a))
        return e

    e0 = energy(st)
    fin, _ = jax.jit(lambda p, w, st: run_rk4(p, w, st, dt, 100))(p, w, st)
    e1 = energy(fin)
    fin2, _ = jax.jit(lambda p, w, st: run_rk4(p, w, st, dt, 100))(p, w, fin)
    e2 = energy(fin2)
    assert e1 < e0 and e2 < e1, (e0, e1, e2)
