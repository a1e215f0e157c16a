"""Waveform-level Green's-function validation of the source stack.

The eigenmode family (SURVEY.md §4.5) validates the OPERATORS; this test
validates the SOURCE stack — delta projection, Gaussian mollification,
wavelet timing, amplitude, receiver sampling — against the closed-form
full-space solution for the explosive point source (ExplosionGreens3D in
solver/analytic.py, derived in this code's own injection convention).
The reference anchored sources on qualitative checks only (SURVEY.md §4.4
— causality, moveout, energy decay); a quantitative waveform comparison
is beyond-parity.

Geometry notes (all measured, see BENCH_NOTES-adjacent scans):
- receivers must sit OFF the structured mesh's symmetry planes — a point
  on an element face samples one side of a DG jump and the error there
  converges much more slowly;
- receivers must sit outside the mollifier support (r >> 4*radius) or the
  comparison is dominated by the DG projection of the Gaussian;
- the comparison window stops before the first boundary-reflection
  arrival (sponge + characteristic faces damp but don't eliminate it).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    ExplosionGreens3D,
    PointSource,
    State,
    absorbing_bc_fn,
    build_receivers,
    build_sources,
    cfl_dt,
    run,
    sponge_mask,
)

SRC = (0.515, 0.505, 0.525)  # off-vertex
REC = np.array([
    [0.745, 0.615, 0.575],  # r = 0.26
    [0.305, 0.365, 0.665],  # r = 0.29
    [0.635, 0.655, 0.285],  # r = 0.31
])


def test_explosion_greens_3d():
    n, degree, f0 = 12, 2, 2.0
    mat = Material(rho=1.5, vp=2.0, vs=1.0)
    extents = ((0.0, 1.0),) * 3
    dm = build_discrete(box_mesh(n, n, n), degree,
                        bc_fn=absorbing_bc_fn(extents, free_sides=[]))
    p = build_params(dm, mat, dtype=jnp.float64)
    t0, radius, amp = 1.2 / f0, 1.0 / n, 3.0
    src = build_sources(
        dm, [PointSource(position=SRC, f0=f0, t0=t0, amplitude=amp,
                         radius=radius)], dtype=jnp.float64)
    rcv = build_receivers(dm, REC, dtype=jnp.float64)
    damp = jnp.asarray(
        sponge_mask(dm, [(a, s) for a in range(3) for s in ("lo", "hi")],
                    width=0.12), dtype=jnp.float64)
    dt = cfl_dt(float(dm.h.min()), 2.0, degree, cfl=0.4)
    n_steps = int(np.ceil(1.05 / dt))
    E, n_p = dm.num_elements, dm.re.n_p
    s0 = State(u=jnp.zeros((E, n_p, 3)), s=jnp.zeros((E, n_p, 6)))
    _, seis = run(p, s0, dt, n_steps, order=4, src=src, damp=damp,
                  receivers=rcv, record_pressure=True)
    seis = np.asarray(seis)  # (T, R, 4): velocity + pressure

    ana = ExplosionGreens3D(mat=mat, position=np.array(SRC), f0=f0, t0=t0,
                            amplitude=amp, radius=radius)
    tg = (np.arange(n_steps) + 1) * dt
    ref_v = ana.velocity(REC, tg)  # (T, R, 3)
    ref_p = ana.pressure(REC, tg)  # (T, R, 1)

    # window: first reflection path src -> nearest face -> receiver is
    # >= 0.72 long -> arrives after t0 + 0.36 + (pulse onset) ~ 0.96
    m = tg < 0.95
    for r in range(len(REC)):
        ev = (np.linalg.norm(seis[m, r, :3] - ref_v[m, r])
              / np.linalg.norm(ref_v[m, r]))
        ep = (np.linalg.norm(seis[m, r, 3] - ref_p[m, r, 0])
              / np.linalg.norm(ref_p[m, r, 0]))
        # measured at this resolution: vel 0.018-0.055, pres 0.059-0.090
        assert ev < 0.12, (r, ev)
        assert ep < 0.18, (r, ep)

    # convention/sign check: the SIGNED correlation with the analytic
    # pulse pins the amplitude sign (a flipped injection convention
    # correlates at ~-1, not +0.995; an onset-sign check would be
    # fragile — the Ricker's leading side lobe flips the first wiggle)
    a0 = ref_v[m, 0].reshape(-1)
    s0_ = seis[m, 0, :3].reshape(-1)
    corr = (a0 @ s0_) / (np.linalg.norm(a0) * np.linalg.norm(s0_))
    assert corr > 0.995, corr


def test_greens_point_vs_mollified_far_field():
    """Host-only consistency: the mollified solution approaches the point
    solution at the physical smearing rate ~(k sigma)^2 (the quadrature
    superposition itself is exact; measured gap at radius=0.01 is 0.0039
    = (2 pi f0 / vp * radius)^2 on the nose)."""
    mat = Material(rho=1.5, vp=2.0, vs=1.0)
    kw = dict(mat=mat, position=np.zeros(3), f0=2.0, t0=0.6, amplitude=3.0)
    pt = ExplosionGreens3D(radius=None, **kw)
    x = np.array([[1.1, 0.7, 0.9]])
    t = np.linspace(0.0, 2.0, 300)
    vp_, pp = pt.velocity(x, t), pt.pressure(x, t)
    for radius, tol in ((0.01, 6e-3), (0.003, 6e-4)):
        mo = ExplosionGreens3D(radius=radius, **kw)
        assert (np.linalg.norm(vp_ - mo.velocity(x, t))
                / np.linalg.norm(vp_)) < tol
        assert (np.linalg.norm(pp - mo.pressure(x, t))
                / np.linalg.norm(pp)) < tol


@pytest.mark.parametrize("bad", ["on_source"])
def test_greens_rejects_receiver_on_source(bad):
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    g = ExplosionGreens3D(mat=mat, position=np.zeros(3), f0=1.0, t0=1.2)
    with pytest.raises(ValueError):
        g.velocity(np.zeros((1, 3)), np.array([0.0]))
