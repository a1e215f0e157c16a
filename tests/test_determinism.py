"""Determinism test (SURVEY.md §7.2).

The reference's race-freedom story (MPI ownership / coloring) maps here to:
no scatter races exist by construction (face-owner gather formulation), and
the same inputs must produce bitwise-identical trajectories run-to-run.
"""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PlaneWave,
    PointSource,
    State,
    build_sources,
    cfl_dt,
    interpolate,
    run,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _final(dm, p, st, dt, n_steps, src):
    fin, _ = jax.jit(
        lambda p, st: run(p, st, dt, n_steps, order=4, src=src)
    )(p, st)
    return np.asarray(fin.u), np.asarray(fin.s)


def test_bitwise_deterministic():
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 0.0]), mode="S")
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    src = build_sources(
        dm, [PointSource(position=(0.52, 0.48), f0=6.0, radius=0.1)],
        dtype=jnp.float64,
    )
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    u1, s1 = _final(dm, p, st, dt, 15, src)
    u2, s2 = _final(dm, p, st, dt, 15, src)
    assert np.array_equal(u1, u2)
    assert np.array_equal(s1, s2)
