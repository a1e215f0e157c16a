"""Reflection/transmission at a material interface vs analytic coefficients.

Textbook normal-incidence P-wave at an impedance contrast Z1 -> Z2:
velocity amplitudes obey R_v = (Z1 - Z2)/(Z1 + Z2), T_v = 2 Z1/(Z1 + Z2).
This validates the heterogeneous-impedance Godunov flux (ops/upwind.py)
end-to-end — the physics the explosive-source configs (layered/salt, [D]
config 4) rely on.
"""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.upwind import build_upwind_data
from seigen_jax.solver import State, cfl_dt
from seigen_jax.solver.models import Layer
from seigen_jax.solver.rk4 import run_rk4


def test_p_wave_reflection_transmission():
    # left medium: rho=1, vp=2 -> Z1=2 ; right: rho=2, vp=3 -> Z2=6
    # R_v = (2-6)/(2+6) = -0.5, T_v = 2*2/8 = 0.5
    rho1, vp1, vs1 = 1.0, 2.0, 1.0
    rho2, vp2, vs2 = 2.0, 3.0, 1.5
    Z1, Z2 = rho1 * vp1, rho2 * vp2
    R_v = (Z1 - Z2) / (Z1 + Z2)
    T_v = 2 * Z1 / (Z1 + Z2)

    topo = rect_mesh(96, 8, lx=2.0, ly=1.0 / 6.0, periodic=(1,))
    dm = build_discrete(topo, 3)  # default free BCs at x=0,2 (pulse never
    # reaches them within T)
    cent = dm.coords.mean(axis=1)[:, 0]
    left = cent < 1.0
    rho = np.where(left, rho1, rho2)
    vp = np.where(left, vp1, vp2)
    vs = np.where(left, vs1, vs2)
    mat = Material(rho=rho, vp=vp, vs=vs)
    p = build_params(dm, mat, dtype=jnp.float64)
    w = build_upwind_data(dm, mat, dtype=jnp.float64)

    # rightward-moving P pulse in the left medium:
    # u_x = A g(x), sigma_xx = -Z1 u_x (simple-wave relation)
    A, x0, wid = 1.0, 0.55, 0.06
    x = dm.coords[:, :, 0]
    g = A * np.exp(-((x - x0) ** 2) / (2 * wid**2))
    E, n_p = dm.num_elements, dm.re.n_p
    u0 = np.zeros((E, n_p, 2))
    s0 = np.zeros((E, n_p, 3))
    u0[:, :, 0] = g
    s0[:, :, 0] = -Z1 * g
    st = State(u=jnp.asarray(u0), s=jnp.asarray(s0))

    dt = cfl_dt(dm.h.min(), vp2, 3, 0.4)
    # travel 0.45 to the interface at vp1=2 (0.225), then ~0.2 more to
    # separate the reflected/transmitted pulses
    T = 0.36
    n_steps = int(np.ceil(T / dt))
    fin, _ = jax.jit(
        lambda p, w, st: run_rk4(p, w, st, dt, n_steps)
    )(p, w, st)
    ux = np.asarray(fin.u)[:, :, 0]
    nodes_x = dm.coords[:, :, 0]

    # reflected pulse: left of interface, moving left; transmitted: right
    refl_peak = np.abs(ux[nodes_x < 0.95]).max()
    trans_peak = np.abs(ux[nodes_x > 1.05]).max()
    assert abs(refl_peak - abs(R_v) * A) < 0.05 * A, (refl_peak, R_v)
    assert abs(trans_peak - T_v * A) < 0.05 * A, (trans_peak, T_v)
    # reflected velocity flips sign (R_v < 0)
    iref = np.unravel_index(
        np.abs(np.where(nodes_x < 0.95, ux, 0.0)).argmax(), ux.shape)
    assert ux[iref] * A < 0, "reflected velocity must be sign-flipped"
