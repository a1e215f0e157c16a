"""The XLA paths that ``--impl auto`` sends work to on every device:
upwind-RK4 (with and without viscoelastic Q) on unstructured element
order, and the general domain-decomposition path with the full source /
receiver / sponge pipeline on virtual devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.upwind import build_upwind_data
from seigen_jax.ops.viscoelastic import build_visco
from seigen_jax.parallel import run_distributed
from seigen_jax.solver import (
    PointSource, State, absorbing_bc_fn, build_receivers, build_sources,
    cfl_dt, line, run, sponge_mask)
from seigen_jax.solver.rk4 import run_rk4, run_rk4_visco

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _case(dim, scramble, degree=2):
    topo = rect_mesh(6, 6) if dim == 2 else box_mesh(3, 3, 3)
    if scramble:
        rng = np.random.default_rng(3)
        topo = dataclasses.replace(
            topo, cells=topo.cells[rng.permutation(topo.num_cells)],
            structure=None)
    extents = ((0.0, 1.0),) * dim
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        extents, free_sides=[(dim - 1, "hi")]))
    h = float(dm.h.min())
    src = build_sources(dm, [PointSource(position=(0.47,) * dim, f0=3.0,
                                         t0=0.1, radius=2 * h)],
                        dtype=jnp.float64, mat=MAT)
    # off every element face (not on the cell diagonals either): the
    # sampled element is the same in both orders
    a, b = (0.213, 0.371, 0.129)[:dim], (0.781, 0.617, 0.893)[:dim]
    rcv = build_receivers(dm, line(a, b, 4), dtype=jnp.float64)
    damp = jnp.asarray(sponge_mask(dm, [(0, "lo")], width=0.3))
    p = build_params(dm, MAT, dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, dim)), s=jnp.zeros((E, n_p, p.n_sig)))
    return dm, p, src, rcv, damp, st, cfl_dt(h, 2.0, degree, 0.4)


@pytest.mark.parametrize("visco", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_upwind_rk4_element_order_invariance(dim, visco):
    """Upwind-RK4 (+ Q) seismograms do not depend on the element order:
    a scrambled (unstructured) mesh reproduces the ordered one."""
    seis = {}
    for scramble in (False, True):
        dm, p, src, rcv, damp, st, dt = _case(dim, scramble)
        w = build_upwind_data(dm, MAT, dtype=jnp.float64)
        if visco:
            v = build_visco(p, 40.0, 25.0, 1.0, 8.0)
            _, _, s = jax.jit(lambda p, w, v, st: run_rk4_visco(
                p, w, v, st, dt, 12, src=src, damp=damp,
                receivers=rcv))(p, w, v, st)
        else:
            _, s = jax.jit(lambda p, w, st: run_rk4(
                p, w, st, dt, 12, src=src, damp=damp,
                receivers=rcv))(p, w, st)
        seis[scramble] = np.asarray(s)
    assert np.abs(seis[False]).max() > 0
    np.testing.assert_allclose(seis[True], seis[False], rtol=1e-9,
                               atol=1e-12 * np.abs(seis[False]).max())


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_general_dd_3d_source_pipeline(n_shards):
    """The --shards path (general DD, ppermute halos) with source,
    receivers and sponge in 3D equals the one-device scan."""
    dm, p, src, rcv, damp, st, dt = _case(3, False)
    fin_ref, seis_ref = jax.jit(lambda p, st: run(
        p, st, dt, 10, order=4, src=src, damp=damp, receivers=rcv))(p, st)
    fin, seis, plan = run_distributed(
        dm, MAT, st, dt, 10, n_devices=n_shards, sources=src, damp=damp,
        receivers=rcv, dtype=jnp.float64)
    assert plan.n_shards == n_shards
    scale = float(np.abs(np.asarray(seis_ref)).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(seis), np.asarray(seis_ref),
                               rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(
        np.asarray(fin.u), np.asarray(fin_ref.u), rtol=0,
        atol=1e-10 * float(np.abs(np.asarray(fin_ref.u)).max()))
