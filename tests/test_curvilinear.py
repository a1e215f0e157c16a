"""Curvilinear (isoparametric) operators (ops/curvilinear.py).

Three-legged verification:
  1. AFFINE-LIMIT EXACTNESS: on straight meshes all quadratures are
     exact, so the per-element curved operators must reproduce the
     affine einsum operators to roundoff (2D and 3D, mixed BCs) —
     this locks every shared ingredient (mass, lifts, normals, BC
     coefficients, trace interpolation).
  2. OPERATOR CONVERGENCE on genuinely curved meshes: apply the ops to
     nodal interpolants of smooth analytic fields and check the error
     against the analytic div/Hooke at the curved nodes decays at
     O(h^q) under refinement — the realized isoparametric accuracy.
  3. LF4 stability smoke on a curved mesh through the standard
     make_step vel_op/stress_op hooks.
"""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.curvilinear import (
    build_curvi,
    curved_coords,
    make_curvi_ops,
)
from seigen_jax.ops.elastic import apply_stress_op, apply_vel_op
from seigen_jax.solver import State, absorbing_bc_fn, cfl_dt, run

MAT = Material(rho=1.3, vp=2.0, vs=1.1)


def test_affine_limit_exact():
    """Identity geometry: curved operators == affine einsum operators."""
    rng = np.random.default_rng(0)
    for dm in (
        build_discrete(rect_mesh(4, 3), 2,
                       bc_fn=absorbing_bc_fn(((0, 1), (0, 1)),
                                             free_sides=[(1, "hi")])),
        build_discrete(box_mesh(2, 2, 2), 2),
    ):
        E, n_p, dim = dm.coords.shape
        p = build_params(dm, MAT, dtype=jnp.float64)
        cp = build_curvi(dm, dm.coords, dtype=jnp.float64)
        vop, sop = make_curvi_ops(cp)
        sig = jnp.asarray(rng.standard_normal((E, n_p, p.n_sig)))
        u = jnp.asarray(rng.standard_normal((E, n_p, dim)))
        np.testing.assert_allclose(
            np.asarray(vop(p, sig)), np.asarray(apply_vel_op(p, sig)),
            rtol=1e-10, atol=1e-11)
        np.testing.assert_allclose(
            np.asarray(sop(p, u)), np.asarray(apply_stress_op(p, u)),
            rtol=1e-10, atol=1e-11)


def _phi(a):
    """Smooth diffeomorphism of the unit square (small a keeps detJ>0)."""
    def f(x):
        out = x.copy()
        out[:, 0] = x[:, 0] + a * np.sin(np.pi * x[:, 0]) * np.sin(
            2 * np.pi * x[:, 1])
        out[:, 1] = x[:, 1] + a * np.sin(2 * np.pi * x[:, 0]) * np.sin(
            np.pi * x[:, 1])
        return out
    return f


def _sigma_star(x, y):
    """Smooth analytic stress field + its divergence (closed form)."""
    sxx = np.sin(1.3 * x) * np.cos(0.7 * y)
    syy = np.cos(0.9 * x) * np.sin(1.1 * y)
    sxy = np.sin(0.8 * x) * np.sin(0.6 * y)
    dxx_dx = 1.3 * np.cos(1.3 * x) * np.cos(0.7 * y)
    dyy_dy = 1.1 * np.cos(0.9 * x) * np.cos(1.1 * y)
    dxy_dx = 0.8 * np.cos(0.8 * x) * np.sin(0.6 * y)
    dxy_dy = 0.6 * np.sin(0.8 * x) * np.cos(0.6 * y)
    sig = np.stack([sxx, syy, sxy], axis=-1)
    div = np.stack([dxx_dx + dxy_dy, dxy_dx + dyy_dy], axis=-1)
    return sig, div


def _u_star(x, y, lam, mu):
    """Smooth velocity field + analytic Hooke(sym grad) (closed form)."""
    ux = np.sin(1.2 * x) * np.cos(0.5 * y)
    uy = np.cos(0.6 * x) * np.sin(1.4 * y)
    dux_dx = 1.2 * np.cos(1.2 * x) * np.cos(0.5 * y)
    dux_dy = -0.5 * np.sin(1.2 * x) * np.sin(0.5 * y)
    duy_dx = -0.6 * np.sin(0.6 * x) * np.sin(1.4 * y)
    duy_dy = 1.4 * np.cos(0.6 * x) * np.cos(1.4 * y)
    divu = dux_dx + duy_dy
    u = np.stack([ux, uy], axis=-1)
    ds = np.stack([
        lam * divu + 2 * mu * dux_dx,
        lam * divu + 2 * mu * duy_dy,
        mu * (dux_dy + duy_dx),
    ], axis=-1)
    return u, ds


def _interior_mask(dm):
    from seigen_jax.mesh.discrete import BC_INTERIOR

    return (dm.bc == BC_INTERIOR).all(axis=1)


def _op_errors(n, degree):
    dm = build_discrete(rect_mesh(n, n), degree)
    p = build_params(dm, MAT, dtype=jnp.float64)
    X = curved_coords(dm, _phi(0.03))
    cp = build_curvi(dm, X, dtype=jnp.float64)
    vop, sop = make_curvi_ops(cp)
    x, y = X[..., 0], X[..., 1]
    inner = _interior_mask(dm)

    sig, div = _sigma_star(x, y)
    got = np.asarray(vop(p, jnp.asarray(sig)))
    irho = float(np.asarray(p.inv_rho)[0])
    e_v = np.abs(got[inner] - irho * div[inner]).max()

    lam = float(np.asarray(p.lam)[0])
    mu = float(np.asarray(p.mu)[0])
    u, ds = _u_star(x, y, lam, mu)
    got_s = np.asarray(sop(p, jnp.asarray(u)))
    e_s = np.abs(got_s[inner] - ds[inner]).max()
    return e_v, e_s


def test_curved_operator_convergence():
    """On genuinely curved meshes the operators converge at O(h^q)
    against analytic div/Hooke of smooth fields (interior elements;
    boundary faces carry BC flux terms by design)."""
    # P3 is pre-asymptotic at n=4 (order 2.15 there, 2.96 for 8->16);
    # measure each degree on its asymptotic pair.
    for degree, n1, n2, floor in ((2, 4, 8, 1.6), (3, 8, 16, 2.6)):
        e1 = _op_errors(n1, degree)
        e2 = _op_errors(n2, degree)
        for k, name in ((0, "vel"), (1, "stress")):
            order = np.log2(e1[k] / e2[k])
            assert order > floor, (
                f"P{degree} {name}: order {order:.2f} (errors "
                f"{e1[k]:.3e} -> {e2[k]:.3e})")


def test_curved_lf4_stability():
    """LF4 on a curved mesh through the standard vel_op/stress_op hooks:
    finite, and energy does not blow up over a few hundred steps."""
    dm = build_discrete(
        rect_mesh(8, 8), 2,
        bc_fn=absorbing_bc_fn(((0, 1), (0, 1)), free_sides=[(1, "hi")]))
    p = build_params(dm, MAT, dtype=jnp.float64)
    X = curved_coords(dm, _phi(0.03))
    cp = build_curvi(dm, X, dtype=jnp.float64)
    vop, sop = make_curvi_ops(cp)
    E, n_p, dim = X.shape
    rng = np.random.default_rng(1)
    # smooth initial velocity bump
    x, y = X[..., 0], X[..., 1]
    bump = np.exp(-60.0 * ((x - 0.5) ** 2 + (y - 0.55) ** 2))
    st = State(
        u=jnp.asarray(np.stack([bump, 0 * bump], axis=-1)),
        s=jnp.zeros((E, n_p, 3), jnp.float64),
    )
    # curved elements shrink the true CFL a bit; take a margin
    dt = cfl_dt(float(dm.h.min()), 2.0, 2, 0.3)
    e0 = float(jnp.sum(st.u**2))
    fin, _ = run(p, st, dt, 300, order=4, vel_op=vop, stress_op=sop)
    assert np.all(np.isfinite(np.asarray(fin.u)))
    e1 = float(jnp.sum(fin.u**2) + jnp.sum(fin.s**2))
    assert e1 < 50.0 * e0
