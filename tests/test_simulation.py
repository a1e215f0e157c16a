"""ElasticSimulation facade tests (API parity with reference ElasticLF4)."""

import numpy as np

from seigen_jax.mesh import rect_mesh
from seigen_jax.ops import Material
from seigen_jax.solver import PointSource, line
from seigen_jax.solver.simulation import ElasticSimulation, SimConfig


def test_facade_end_to_end():
    sim = ElasticSimulation(
        rect_mesh(16, 8, lx=2.0, ly=1.0),
        Material(rho=1.0, vp=2.0, vs=1.0),
        SimConfig(
            degree=2,
            order=4,
            dtype="float64",
            free_sides=((1, "hi"),),
            absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
            sponge_width=0.2,
            impl="auto",  # on CPU: the XLA gather (ops/select.py)
        ),
        sources=[PointSource(position=(1.0, 0.8), f0=6.0, radius=0.15)],
        receiver_points=line((0.3, 0.9), (1.7, 0.9), 5),
    )
    fin, seis = sim.run(T=0.3)
    assert seis is not None and seis.shape[1] == 5
    assert np.all(np.isfinite(seis))
    u = np.asarray(fin.u)
    assert np.all(np.isfinite(u)) and np.abs(u).max() > 1e-12


def test_facade_impl_equivalence():
    """The roll-exchange engine matches plain einsum trajectories."""
    def build(impl):
        return ElasticSimulation(
            rect_mesh(8, 8),
            Material(rho=1.0, vp=2.0, vs=1.0),
            SimConfig(degree=2, dtype="float64", impl=impl),
            sources=[PointSource(position=(0.5, 0.5), f0=6.0, radius=0.15)],
        )

    a = build("einsum")
    b = build("xla_roll")
    fa, _ = a.run(T=0.1)
    fb, _ = b.run(T=0.1)
    assert np.allclose(np.asarray(fa.u), np.asarray(fb.u), atol=1e-13)


def test_facade_upwind_and_attenuation():
    """scheme='upwind-rk4' (+ viscoelastic Q) through the facade: the
    attenuated run is weaker than the elastic twin at late times."""
    def build(**kw):
        return ElasticSimulation(
            rect_mesh(12, 6, lx=2.0, ly=1.0),
            Material(rho=1.0, vp=2.0, vs=1.0),
            SimConfig(
                degree=1, dtype="float64", scheme="upwind-rk4",
                free_sides=((1, "hi"),),
                absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo")),
                sponge_width=0.2, **kw),
            sources=[PointSource(position=(1.0, 0.7), f0=4.0,
                                 radius=0.2)],
            receiver_points=line((0.3, 0.9), (1.7, 0.9), 4),
        )

    _, seis_e = build().run(T=0.8)
    _, seis_q = build(q_kappa=15.0, q_mu=15.0, q_band=(1.0, 10.0)).run(
        T=0.8)
    assert np.all(np.isfinite(seis_q))
    n = len(seis_q) // 2
    assert np.abs(seis_q[n:]).max() < np.abs(seis_e[n:]).max()

    import pytest

    with pytest.raises(ValueError):
        build(q_mu=20.0, q_band=None)  # band required
