"""Unstructured meshes: structure recovery, and the fused operator kernel
on scrambled (structure-free) meshes.

Oracle: the general einsum path (ops/elastic.py) — the kernel, which
gathers neighbour traces through the same ``nbr`` table, must reproduce
it on scrambled meshes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.dg_kernel import make_kernel_ops
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

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def scrambled(topo, seed=0):
    """Randomly permute cell order and drop structure metadata — an
    honest stand-in for a Gmsh import of the same geometry."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(topo.num_cells)
    return dataclasses.replace(topo, cells=topo.cells[perm], structure=None)


def test_structure_recovery():
    """Scrambled lattice meshes are recognized and reordered so the roll
    exchange engages; irregular meshes are left untouched."""
    import dataclasses as dc

    from seigen_jax.mesh.recover import recover_structure
    from seigen_jax.ops.structured_exchange import detect_structured

    rng = np.random.default_rng(1)
    for topo in (rect_mesh(8, 6), box_mesh(4, 4, 4),
                 rect_mesh(10, 4, lx=2.0)):
        rec = recover_structure(scrambled(topo, seed=2))
        assert rec.structure is not None
        dm = build_discrete(rec, 2)
        assert detect_structured(dm) is not None
        # pure element reordering: same cells as sets
        a = np.sort(np.sort(rec.cells, axis=1), axis=0)
        b = np.sort(np.sort(topo.cells, axis=1), axis=0)
        np.testing.assert_array_equal(a, b)

    # negative control: perturbed interior vertices -> no recovery
    pert = rect_mesh(6, 6)
    v = pert.vertices.copy()
    inner = ((v[:, 0] > 0.01) & (v[:, 0] < 0.99)
             & (v[:, 1] > 0.01) & (v[:, 1] < 0.99))
    v[inner] += 0.02 * rng.standard_normal(v[inner].shape)
    pert = dataclasses.replace(pert, vertices=v, structure=None)
    assert recover_structure(pert).structure is None


def test_structure_recovery_same_physics():
    """A recovered (reordered) mesh produces the same seismograms as the
    original through the simulation facade."""
    from seigen_jax.solver.simulation import ElasticSimulation, SimConfig

    topo = rect_mesh(6, 6)
    cfg = SimConfig(degree=2, impl="einsum", dtype="float64",
                    absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
                    free_sides=((1, "hi"),), sponge_width=0.2)
    pts = line((0.25, 0.9), (0.75, 0.9), 3)
    srcs = [PointSource(position=(0.5, 0.6), f0=2.0, radius=0.3)]
    sim_a = ElasticSimulation(topo, MAT, cfg, sources=srcs,
                              receiver_points=pts)
    sim_b = ElasticSimulation(scrambled(topo, seed=4), MAT, cfg,
                              sources=srcs, receiver_points=pts)
    assert sim_b.topology.structure is not None  # recovery kicked in
    _, seis_a = sim_a.run(0.2)
    _, seis_b = sim_b.run(0.2)
    np.testing.assert_allclose(seis_b, seis_a, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dim,degree,block",
                         [(2, 2, 16), (3, 1, 16), (2, 2, 32)])
def test_unstructured_runner_matches_general(dim, degree, block):
    """A sponge + source + receiver LF4 scan on a scrambled mesh: the
    fused kernel (interpreted) against the einsum gather."""
    topo = (rect_mesh(8, 6) if dim == 2 else box_mesh(3, 2, 2))
    dm = build_discrete(scrambled(topo, seed=11), degree)
    p = build_params(dm, MAT, dtype=jnp.float32)
    h = float(dm.h.min())
    dt = cfl_dt(h, 2.0, degree, 0.4)
    n_steps = 12
    E, n_p = dm.num_elements, dm.re.n_p
    n_sig = 3 if dim == 2 else 6
    src = build_sources(
        dm, [PointSource(position=(0.4,) * dim, f0=2.0, radius=2 * h)],
        dtype=jnp.float32, mat=MAT)
    damp = jnp.asarray(sponge_mask(dm, [(0, "lo")], width=0.3),
                       jnp.float32)
    rcv = build_receivers(dm, line((0.2,) * dim, (0.8,) * dim, 3),
                          dtype=jnp.float32)
    st = State(u=jnp.zeros((E, n_p, dim), jnp.float32),
               s=jnp.zeros((E, n_p, n_sig), jnp.float32))

    def scan(vel_op=None, stress_op=None):
        ops = {} if vel_op is None else dict(vel_op=vel_op,
                                             stress_op=stress_op)
        return jax.jit(lambda p, st: run(
            p, st, dt, n_steps, order=4, src=src, damp=damp,
            receivers=rcv, **ops))(p, st)

    ref, seis_ref = scan()
    out, seis = scan(*make_kernel_ops(block=block, interpret=True))
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.s), np.asarray(ref.s),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(seis), np.asarray(seis_ref),
                               rtol=2e-4, atol=1e-6)
