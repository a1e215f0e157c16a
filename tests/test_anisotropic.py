"""Anisotropic stiffness operators: isotropic-limit equivalence, Christoffel
speeds, and VTI SH-wave propagation at the anisotropic (not isotropic)
velocity."""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, apply_stress_op, build_params
from seigen_jax.ops.anisotropic import (
    christoffel_speeds,
    iso_stiffness,
    make_aniso_stress_op,
    max_wavespeed,
    vti_stiffness,
)
from seigen_jax.solver import State, cfl_dt, run

MAT = Material(rho=1.3, vp=2.0, vs=1.1)


def test_isotropic_stiffness_matches_standard_op():
    """C(lam, mu) through the aniso einsum == the hand-written isotropic
    stress operator, 2D and 3D, to machine precision."""
    for dm in (build_discrete(rect_mesh(4, 3), 2),
               build_discrete(box_mesh(2, 2, 2), 2)):
        p = build_params(dm, MAT, dtype=jnp.float64)
        E = dm.num_elements
        lam, mu = float(np.asarray(MAT.lam)), float(np.asarray(MAT.mu))
        C = jnp.asarray(np.broadcast_to(
            iso_stiffness(lam, mu, dm.dim), (E,) + (3 if dm.dim == 2
                                                    else 6,) * 2))
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.standard_normal((E, dm.re.n_p, dm.dim)))
        ref = apply_stress_op(p, u)
        out = make_aniso_stress_op(C)(p, u)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-13, atol=1e-13)


def test_christoffel_isotropic_limit():
    lam, mu, rho = 2.0, 1.0, 1.3
    C = iso_stiffness(lam, mu, 3)
    for n in ([1, 0, 0], [0, 0, 1], [1, 1, 1], [0.3, -0.7, 0.2]):
        v = christoffel_speeds(C, rho, n)
        np.testing.assert_allclose(v[:2], np.sqrt(mu / rho), rtol=1e-12)
        np.testing.assert_allclose(v[2], np.sqrt((lam + 2 * mu) / rho),
                                   rtol=1e-12)


def test_vti_christoffel_axes():
    """Thomsen parametrization: qP vertical = vp, horizontal =
    vp sqrt(1+2eps); SH horizontal = vs sqrt(1+2gamma)."""
    vp, vs, rho, eps, gam = 2.0, 1.0, 1.0, 0.2, 0.3
    C = vti_stiffness(vp, vs, rho, epsilon=eps, delta=0.1, gamma=gam)
    v_vert = christoffel_speeds(C, rho, [0, 0, 1])
    np.testing.assert_allclose(v_vert[2], vp, rtol=1e-12)
    v_horz = christoffel_speeds(C, rho, [1, 0, 0])
    np.testing.assert_allclose(v_horz[2], vp * np.sqrt(1 + 2 * eps),
                               rtol=1e-12)
    # SH (y-polarized for x-propagation) speed = sqrt(C66/rho)
    np.testing.assert_allclose(sorted(v_horz[:2])[1],
                               vs * np.sqrt(1 + 2 * gam), rtol=1e-12)
    assert max_wavespeed(C, rho) >= vp * np.sqrt(1 + 2 * eps) - 1e-9


def test_vti_sh_wave_speed():
    """An SH plane wave (x-propagating, y-polarized) in a VTI medium
    travels at sqrt(C66/rho) = vs sqrt(1+2 gamma): initialized with the
    ANISOTROPIC speed it returns after one period (small error);
    initialized with the isotropic speed it does not."""
    vp, vs, rho, gam = 2.0, 1.0, 1.0, 0.3
    C_np = vti_stiffness(vp, vs, rho, gamma=gam)
    c_sh = np.sqrt(C_np[5, 5] / rho)
    dm = build_discrete(box_mesh(8, 2, 2, periodic=(0, 1, 2)), 3)
    p = build_params(dm, Material(rho=rho, vp=vp, vs=vs),
                     dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    C = jnp.asarray(np.broadcast_to(C_np, (E, 6, 6)))
    stress_op = make_aniso_stress_op(C)
    k = 2 * np.pi
    vmax = max_wavespeed(C_np, rho)
    dt = cfl_dt(dm.h.min(), vmax, 3, 0.4)
    x = np.asarray(dm.coords)[:, :, 0]

    def run_T(T):
        n_steps = int(np.ceil(T / dt))
        dtp = T / n_steps
        u = np.zeros((E, n_p, 3))
        u[:, :, 1] = np.cos(k * x)
        s = np.zeros((E, n_p, 6))
        # right-going SH wave: sigma_xy = -Z v with Z = rho c_sh
        s[:, :, 5] = -rho * c_sh * np.cos(k * (x - c_sh * 0.5 * dtp))
        st = State(u=jnp.asarray(u), s=jnp.asarray(s))
        fin, _ = jax.jit(
            lambda p, st: run(p, st, dtp, n_steps, order=4,
                              stress_op=stress_op))(p, st)
        u1 = np.asarray(fin.u[:, :, 1])
        u0 = np.cos(k * x)
        return np.sqrt(((u1 - u0) ** 2).mean()) / np.sqrt((u0**2).mean())

    T_aniso = 2 * np.pi / (k * c_sh)
    T_iso = 2 * np.pi / (k * vs)
    e_good = run_T(T_aniso)  # back in phase after the ANISO period
    e_iso = run_T(T_iso)  # isotropic period: wave overshot by the
    # anisotropy factor, phase error 2 pi (c_sh/vs - 1)
    assert e_good < 0.02, e_good
    expected_phase_err = 2 * abs(np.sin(np.pi * (c_sh / vs - 1.0)))
    assert e_iso > 0.5 * expected_phase_err, (e_iso, expected_phase_err)


def test_facade_stiffness_option():
    """ElasticSimulation(stiffness=C) runs the aniso einsum path; an
    isotropic C reproduces the isotropic facade solution (same dt forced
    via equal CFL inputs is not guaranteed, so compare fields after the
    same physical time with a loose tolerance)."""
    from seigen_jax.ops.anisotropic import iso_stiffness
    from seigen_jax.solver import PointSource, line
    from seigen_jax.solver.simulation import ElasticSimulation, SimConfig

    mat = MAT
    lam, mu = float(np.asarray(mat.lam)), float(np.asarray(mat.mu))
    cfg = SimConfig(degree=2, dtype="float64",
                    free_sides=((1, "hi"),),
                    absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
                    sponge_width=0.2)
    kw = dict(
        sources=[PointSource(position=(0.5, 0.6), f0=3.0, radius=0.2)],
        receiver_points=line((0.3, 0.9), (0.7, 0.9), 3))
    sim_i = ElasticSimulation(rect_mesh(8, 8), mat, cfg, **kw)
    sim_a = ElasticSimulation(rect_mesh(8, 8), mat, cfg,
                              stiffness=iso_stiffness(lam, mu, 2), **kw)
    assert sim_a._impl == "einsum"
    fin_i, _ = sim_i.run(0.25)
    fin_a, _ = sim_a.run(0.25)
    u_i, u_a = np.asarray(fin_i.u).ravel(), np.asarray(fin_a.u).ravel()
    corr = (u_i @ u_a) / (np.linalg.norm(u_i) * np.linalg.norm(u_a))
    assert corr > 0.999, corr

    import pytest

    with pytest.raises(ValueError):
        ElasticSimulation(
            rect_mesh(4, 4), mat,
            SimConfig(degree=1, scheme="upwind-rk4"),
            stiffness=iso_stiffness(lam, mu, 2))


def test_bond_rotation():
    """Bond transformation sanity: rotations leave isotropic C invariant;
    rotating VTI z->x (HTI) swaps the qP axis speeds; symmetry preserved."""
    from seigen_jax.ops.anisotropic import hti_stiffness, rotate_stiffness

    lam, mu, rho = 2.0, 1.0, 1.3
    Ci = iso_stiffness(lam, mu, 3)
    th = 0.7
    R = np.array([[np.cos(th), 0, np.sin(th)],
                  [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    np.testing.assert_allclose(rotate_stiffness(Ci, R), Ci, atol=1e-12)

    vp, vs, eps, gam = 2.0, 1.0, 0.2, 0.3
    Ch = hti_stiffness(vp, vs, 1.0, epsilon=eps, delta=0.1, gamma=gam)
    np.testing.assert_allclose(Ch, Ch.T, atol=1e-12)  # symmetric
    # symmetry axis now x: qP along x = vp; along z = vp sqrt(1+2 eps)
    np.testing.assert_allclose(
        christoffel_speeds(Ch, 1.0, [1, 0, 0])[2], vp, rtol=1e-12)
    np.testing.assert_allclose(
        christoffel_speeds(Ch, 1.0, [0, 0, 1])[2],
        vp * np.sqrt(1 + 2 * eps), rtol=1e-12)
