"""Partition-invariance tests on 8 fake CPU devices (SURVEY.md §6 #3).

The distributed oracle, as in the reference's MPI testing: running the same
problem on 1 chip and on N shards must agree to roundoff.  Exercises the
Morton partition, halo-exchange planning, ppermute rounds, sharded sources/
receivers/damping — the full config-5 code path without accelerator hardware.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.parallel import make_plan, run_distributed
from seigen_jax.solver import (
    PlaneWave,
    PointSource,
    State,
    absorbing_bc_fn,
    build_receivers,
    build_sources,
    cfl_dt,
    interpolate,
    line,
    run,
    sponge_mask,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _dense_reference(dm, state0, dt, n_steps, order=4, src=None, damp=None,
                     receivers=None):
    fin, seis = jax.jit(
        lambda p, st: run(
            p, st, dt, n_steps, order=order, src=src, damp=damp,
            receivers=receivers,
        )
    )(build_params(dm, MAT, dtype=jnp.float64), state0)
    return fin, seis


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_partition_invariance_2d_periodic(n_shards):
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    dm = build_discrete(rect_mesh(6, 6, periodic=(0, 1)), 2)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    n_steps = 20
    u0 = jnp.asarray(interpolate(dm, pw.u, 0.0))
    s0 = jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt))
    st = State(u=u0, s=s0)

    fin_ref, _ = _dense_reference(dm, st, dt, n_steps)
    fin_sh, _, plan = run_distributed(
        dm, MAT, st, dt, n_steps, n_devices=n_shards, dtype=jnp.float64
    )
    assert plan.n_rounds >= 1
    err_u = np.abs(np.asarray(fin_sh.u) - np.asarray(fin_ref.u)).max()
    err_s = np.abs(np.asarray(fin_sh.s) - np.asarray(fin_ref.s)).max()
    scale = np.abs(np.asarray(fin_ref.u)).max()
    assert err_u < 1e-12 * max(scale, 1.0), err_u
    assert err_s < 1e-12 * max(scale, 1.0), err_s


def test_partition_invariance_2d_source_receivers_damp():
    """Full explosive-source pipeline sharded vs dense, incl. seismograms."""
    extents = ((0.0, 1.0), (0.0, 1.0))
    topo = rect_mesh(10, 10)
    bc_fn = absorbing_bc_fn(extents, free_sides=[(1, "hi")])
    dm = build_discrete(topo, 2, bc_fn=bc_fn)
    src = build_sources(
        dm,
        [PointSource(position=(0.5, 0.7), f0=8.0, radius=0.08)],
        dtype=jnp.float64,
    )
    rec_pts = line((0.2, 0.9), (0.8, 0.9), 5)
    rcv = build_receivers(dm, rec_pts, dtype=jnp.float64)
    damp = jnp.asarray(
        sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")], width=0.2)
    )
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    n_steps = 25
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(
        u=jnp.zeros((E, n_p, 2), dtype=jnp.float64),
        s=jnp.zeros((E, n_p, 3), dtype=jnp.float64),
    )
    fin_ref, seis_ref = _dense_reference(
        dm, st, dt, n_steps, src=src, damp=damp, receivers=rcv
    )
    fin_sh, seis_sh, _ = run_distributed(
        dm, MAT, st, dt, n_steps, n_devices=4, sources=src, damp=damp,
        receivers=rcv, dtype=jnp.float64,
    )
    err = np.abs(np.asarray(fin_sh.u) - np.asarray(fin_ref.u)).max()
    scale = max(np.abs(np.asarray(fin_ref.u)).max(), 1e-30)
    assert err < 1e-10 * max(scale, 1.0), (err, scale)
    assert np.allclose(seis_sh, np.asarray(seis_ref), atol=1e-12)


def test_partition_invariance_3d():
    pw = PlaneWave(
        mat=MAT,
        k=2 * np.pi * np.array([1.0, 0.0, 0.0]),
        mode="S",
        polarization=np.array([0.0, 0.0, 1.0]),
    )
    dm = build_discrete(box_mesh(3, 3, 3, periodic=(0, 1, 2)), 1)
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    n_steps = 10
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    fin_ref, _ = _dense_reference(dm, st, dt, n_steps)
    fin_sh, _, plan = run_distributed(
        dm, MAT, st, dt, n_steps, n_devices=8, dtype=jnp.float64
    )
    err = np.abs(np.asarray(fin_sh.u) - np.asarray(fin_ref.u)).max()
    scale = np.abs(np.asarray(fin_ref.u)).max()
    assert err < 1e-12 * max(scale, 1.0), err


def test_plan_structure():
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    plan = make_plan(dm, 4)
    assert plan.E_pad == plan.n_shards * plan.block
    assert plan.send_idx.shape[0] == 4
    # every round's perm is a valid partial permutation (no duplicate srcs
    # or dsts)
    for pairs in plan.round_perms:
        srcs = [a for a, _ in pairs]
        dsts = [b for _, b in pairs]
        assert len(set(srcs)) == len(srcs)
        assert len(set(dsts)) == len(dsts)
