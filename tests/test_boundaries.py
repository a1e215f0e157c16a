"""Boundary-condition correctness: rigid-wall eigenmode + free-surface checks.

The rigid-wall analytic mode on [0,1] x-periodic-in-y:
  u_y = A sin(pi x) cos(w t),  sigma_xy = (A mu pi / w) cos(pi x) sin(w t),
  w = pi vs
satisfies u = 0 at x = 0,1 (rigid) with nonzero traction there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import BC_RIGID, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import State, cfl_dt, l2_error, run

MAT = Material(rho=1.0, vp=2.0, vs=1.0)
MU = float(np.asarray(MAT.mu))
W = np.pi * 1.0  # pi * vs


def _u(x, t):
    out = np.zeros(x.shape[:-1] + (2,))
    out[..., 1] = np.sin(np.pi * x[..., 0]) * np.cos(W * t)
    return out


def _sigma(x, t):
    out = np.zeros(x.shape[:-1] + (3,))
    out[..., 2] = (MU * np.pi / W) * np.cos(np.pi * x[..., 0]) * np.sin(W * t)
    return out


def _rigid_x_bc(centroids, normals):
    return np.full(len(centroids), BC_RIGID, dtype=np.int8)


@pytest.mark.parametrize("N", [8, 16])
def test_rigid_wall_eigenmode(N):
    topo = rect_mesh(N, N, periodic=(1,))
    dm = build_discrete(topo, 2, bc_fn=_rigid_x_bc)
    assert (dm.bc == BC_RIGID).sum() == 2 * N  # both x walls
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    T = 2 * np.pi / W  # one period
    n_steps = int(np.ceil(T / dt))
    dt = T / n_steps
    from seigen_jax.solver import interpolate

    st = State(
        u=jnp.asarray(interpolate(dm, _u, 0.0)),
        s=jnp.asarray(interpolate(dm, _sigma, 0.5 * dt)),
    )
    fin, _ = jax.jit(lambda p, st: run(p, st, dt, n_steps, order=4))(p, st)
    err = l2_error(dm, np.asarray(fin.u), _u, n_steps * dt)
    # mode amplitude is O(1); discretization error should be small and
    # convergent between the two sizes (checked via parametrize bounds)
    bound = {8: 2.5e-3, 16: 4e-4}[N]
    assert err < bound, err
