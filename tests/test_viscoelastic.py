"""Viscoelastic (memory-variable) attenuation: fit quality, elastic limit,
measured Q vs target."""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.upwind import build_upwind_data
from seigen_jax.ops.viscoelastic import (
    build_visco,
    fit_anelastic_unit,
    model_q_inv,
)
from seigen_jax.solver import PlaneWave, State, cfl_dt, interpolate
from seigen_jax.solver.rk4 import run_rk4, run_rk4_visco

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def test_anelastic_fit_flat_over_band():
    """Fitted Q^-1(f) is flat to ~5% across the target band."""
    f1, f2, L = 0.5, 8.0, 3
    w_l, y = fit_anelastic_unit(f1, f2, L)
    freqs = np.logspace(np.log10(f1), np.log10(f2), 25)
    qinv = model_q_inv(w_l, y, freqs)
    assert np.all(np.abs(qinv - 1.0) < 0.05), (qinv.min(), qinv.max())


def _setup(degree=2, N=12):
    dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), degree)
    p = build_params(dm, MAT, dtype=jnp.float64)
    w = build_upwind_data(dm, MAT, dtype=jnp.float64)
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 0.0]), mode="S")
    dt = cfl_dt(dm.h.min(), 2.0, degree, 0.4)
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.0)),
    )
    return dm, p, w, pw, dt, st


def test_infinite_q_matches_elastic():
    """Q = inf (Y = 0) reproduces the elastic RK4 run exactly."""
    dm, p, w, pw, dt, st = _setup()
    v = build_visco(p, np.inf, np.inf, 0.5, 8.0)
    n = 40
    ref, _ = jax.jit(lambda p, w, st: run_rk4(p, w, st, dt, n))(p, w, st)
    fin, xi, _ = jax.jit(
        lambda p, w, v, st: run_rk4_visco(p, w, v, st, dt, n))(p, w, v, st)
    np.testing.assert_allclose(np.asarray(fin.u), np.asarray(ref.u),
                               rtol=1e-12, atol=1e-14)
    assert float(jnp.abs(xi).max()) == 0.0


def test_measured_q_matches_target():
    """An S plane wave in a Q_mu medium decays at exp(-pi f t / Q):
    the Q measured from the energy envelope matches the target to ~15%."""
    dm, p, w, pw, dt, st = _setup()
    f0 = 1.0 / pw.period  # eigenmode frequency (S wave, |k| = 2 pi)
    Q = 25.0
    v = build_visco(p, 1e9, Q, 0.3 * f0, 3 * f0)
    # run 3 full periods, sampling |u| at period marks (same phase)
    n_per = int(np.ceil(pw.period / dt))
    dtp = pw.period / n_per

    @jax.jit
    def one_period(st, xi):
        fin, xi, _ = run_rk4_visco(p, w, v, st, dtp, n_per, xi0=xi)
        return fin, xi

    E, n_p, n_sig = st.s.shape
    xi = jnp.zeros((E, n_p, n_sig, v.L), dtype=st.s.dtype)
    amps = [float(jnp.sqrt((st.u**2).sum()))]
    for _ in range(3):
        st, xi = one_period(st, xi)
        amps.append(float(jnp.sqrt((st.u**2).sum())))
    amps = np.asarray(amps)
    # per-period amplitude ratio = exp(-pi / Q_eff)
    ratios = amps[1:] / amps[:-1]
    q_eff = -np.pi / np.log(ratios)
    assert np.all(np.abs(q_eff - Q) / Q < 0.15), (q_eff, Q)


def test_visco_wave_still_propagates():
    """Moderate Q does not destroy the waveform: after one period the
    decayed state still correlates >0.95 with the initial eigenmode."""
    dm, p, w, pw, dt, st = _setup()
    f0 = 1.0 / pw.period
    v = build_visco(p, 50.0, 50.0, 0.3 * f0, 3 * f0)
    n_per = int(np.ceil(pw.period / dt))
    dtp = pw.period / n_per
    fin, _, _ = jax.jit(
        lambda p, w, v, st: run_rk4_visco(p, w, v, st, dtp, n_per)
    )(p, w, v, st)
    a = np.asarray(st.u).ravel()
    b = np.asarray(fin.u).ravel()
    corr = (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
    assert corr > 0.95, corr
