"""Adjoint/FWI slice: checkpointed forward parity + gradient correctness."""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PointSource,
    State,
    build_receivers,
    build_sources,
    cfl_dt,
    line,
    run,
    sponge_mask,
)
from seigen_jax.solver.adjoint import (
    make_fwi_gradient,
    run_segmented,
    seismogram_misfit,
    with_material,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _setup(n_steps=12, degree=1, N=5):
    dm = build_discrete(rect_mesh(N, N), degree)
    p = build_params(dm, MAT, dtype=jnp.float64)
    h = float(dm.h.min())
    dt = cfl_dt(h, 2.0, degree, 0.4)
    src = build_sources(
        dm, [PointSource(position=(0.45, 0.7), f0=1.5, radius=2 * h)],
        dtype=jnp.float64, mat=MAT)
    rcv = build_receivers(dm, line((0.2, 0.85), (0.8, 0.85), 4),
                          dtype=jnp.float64)
    damp = jnp.asarray(sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")],
                                   width=0.25), jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    return dm, p, dt, src, rcv, damp, st, n_steps


def test_run_segmented_matches_run():
    dm, p, dt, src, rcv, damp, st, n = _setup(n_steps=12)
    ref_fin, ref_seis = jax.jit(
        lambda p, st: run(p, st, dt, n, order=4, src=src, damp=damp,
                          receivers=rcv))(p, st)
    fin, seis = jax.jit(
        lambda p, st: run_segmented(p, st, dt, n, segment=4, order=4,
                                    src=src, damp=damp, receivers=rcv)
    )(p, st)
    np.testing.assert_allclose(np.asarray(fin.u), np.asarray(ref_fin.u),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(seis), np.asarray(ref_seis),
                               rtol=1e-12, atol=1e-15)


def test_with_material_roundtrip():
    dm, p, *_ = _setup()
    E = dm.num_elements
    vp = jnp.full((E,), 2.3, jnp.float64)
    vs = jnp.full((E,), 1.1, jnp.float64)
    rho = jnp.full((E,), 1.7, jnp.float64)
    p2 = with_material(p, vp=vp, vs=vs, rho=rho)
    np.testing.assert_allclose(np.asarray(p2.mu), 1.7 * 1.1**2)
    np.testing.assert_allclose(np.asarray(p2.lam),
                               1.7 * (2.3**2 - 2 * 1.1**2))
    np.testing.assert_allclose(np.asarray(1.0 / p2.inv_rho), 1.7)
    # partial update keeps the other fields
    p3 = with_material(p2, vs=vs * 1.1)
    np.testing.assert_allclose(np.asarray(1.0 / p3.inv_rho), 1.7)


def test_fwi_gradient_matches_finite_differences():
    """Reverse-mode material gradient vs central finite differences (f64)."""
    dm, p, dt, src, rcv, damp, st, n = _setup(n_steps=10)
    E = dm.num_elements

    # observed data from a perturbed "true" model
    rng = np.random.default_rng(5)
    vp_true = jnp.asarray(2.0 + 0.1 * rng.standard_normal(E))
    p_true = with_material(p, vp=vp_true)
    _, observed = jax.jit(
        lambda p, st: run(p, st, dt, n, order=4, src=src, damp=damp,
                          receivers=rcv))(p_true, st)

    vg, init_theta = make_fwi_gradient(
        p, st, dt, n, src, rcv, observed, fields=("vp",), damp=damp,
        segment=5)
    theta = init_theta()
    loss0, grads = vg(theta)
    assert float(loss0) > 0
    g = np.asarray(grads["vp"])
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0

    def loss_np(vp):
        return float(seismogram_misfit(
            with_material(p, vp=jnp.asarray(vp)), st, dt, n, src, rcv,
            observed, damp=damp))

    vp0 = np.asarray(theta["vp"]).copy()
    # check the largest-|g| elements (informative directions) + one random
    idxs = list(np.argsort(-np.abs(g))[:3]) + [int(rng.integers(0, E))]
    eps = 1e-5
    for i in idxs:
        vpp, vpm = vp0.copy(), vp0.copy()
        vpp[i] += eps
        vpm[i] -= eps
        fd = (loss_np(vpp) - loss_np(vpm)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=2e-5, atol=1e-12)


def test_fwi_descent_reduces_misfit():
    """A few gradient-descent steps on vp reduce the misfit (the FWI loop
    closes end-to-end)."""
    dm, p, dt, src, rcv, damp, st, n = _setup(n_steps=10)
    E = dm.num_elements
    vp_true = jnp.full((E,), 2.1, jnp.float64)
    _, observed = jax.jit(
        lambda p, st: run(p, st, dt, n, order=4, src=src, damp=damp,
                          receivers=rcv))(with_material(p, vp=vp_true), st)
    vg, init_theta = make_fwi_gradient(
        p, st, dt, n, src, rcv, observed, fields=("vp",), damp=damp)
    theta = init_theta()
    losses = []
    for _ in range(4):
        loss, grads = vg(theta)
        losses.append(float(loss))
        gmax = float(jnp.abs(grads["vp"]).max())
        theta = {"vp": theta["vp"] - (0.02 / max(gmax, 1e-30)) * grads["vp"]}
    assert losses[-1] < 0.7 * losses[0], losses


def test_visco_fwi_gradient_matches_finite_differences():
    """Attenuation FWI: d misfit / d (Q^-1) through the memory-variable
    upwind-RK4 scan FD-checked (directional, both fields), segmented
    checkpointing invariant, and one projected descent step reduces the
    misfit toward the true Q."""
    from seigen_jax.ops.upwind import build_upwind_data
    from seigen_jax.solver.adjoint import make_visco_fwi_gradient

    dm = build_discrete(rect_mesh(5, 5), 1)
    p = build_params(dm, MAT, dtype=jnp.float64)
    w = build_upwind_data(dm, MAT, dtype=jnp.float64)
    h = float(dm.h.min())
    dt = cfl_dt(h, 2.0, 1, 0.3)
    n_steps = 12
    src = build_sources(
        dm, [PointSource(position=(0.45, 0.7), f0=1.5, radius=2 * h,
                         amplitude=50.0)],
        dtype=jnp.float64, mat=MAT)
    rcv = build_receivers(dm, line((0.2, 0.85), (0.8, 0.85), 4),
                          dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2), jnp.float64),
               s=jnp.zeros((E, n_p, 3), jnp.float64))
    f_band = (0.3, 5.0)

    # observed data from a heterogeneous TRUE attenuation model
    from seigen_jax.ops.viscoelastic import build_visco
    from seigen_jax.solver.rk4 import run_rk4_visco

    rng = np.random.default_rng(5)
    q_true = 8.0 + 20.0 * rng.random(E)
    v_true = build_visco(p, q_true, q_true, *f_band)
    _, _, observed = jax.jit(
        lambda: run_rk4_visco(p, w, v_true, st, dt, n_steps, src=src,
                              receivers=rcv))()

    vg, init_theta = make_visco_fwi_gradient(
        p, w, st, dt, n_steps, src, rcv, observed, f_band, q0=50.0)
    theta = init_theta()
    v0, g = vg(theta)
    assert float(v0) > 1e-14
    assert set(g) == {"qinv_kappa", "qinv_mu"}

    # directional FD on each field
    for field in ("qinv_kappa", "qinv_mu"):
        dvec = rng.standard_normal(E)
        dvec /= np.abs(dvec).max()
        eps = 1e-6
        tp = dict(theta)
        tm = dict(theta)
        tp[field] = theta[field] + eps * jnp.asarray(dvec)
        tm[field] = theta[field] - eps * jnp.asarray(dvec)
        fd = (float(vg(tp)[0]) - float(vg(tm)[0])) / (2 * eps)
        ad = float(jnp.dot(g[field], jnp.asarray(dvec)))
        np.testing.assert_allclose(ad, fd, rtol=1e-6, err_msg=field)

    # segment checkpointing changes memory, not the gradient
    vg_seg, _ = make_visco_fwi_gradient(
        p, w, st, dt, n_steps, src, rcv, observed, f_band, q0=50.0,
        segment=4)
    v_seg, g_seg = vg_seg(theta)
    np.testing.assert_allclose(float(v_seg), float(v0), rtol=1e-13)
    for field in g:
        np.testing.assert_allclose(np.asarray(g_seg[field]),
                                   np.asarray(g[field]), rtol=1e-11)

    # one projected gradient step descends
    gmax = max(float(jnp.abs(g[f]).max()) for f in g)
    step = 0.02 / gmax
    theta1 = {f: jnp.clip(theta[f] - step * g[f], 0.0, 1.0) for f in g}
    v1, _ = vg(theta1)
    assert float(v1) < float(v0)
