"""C-PML absorbing layers (beyond-parity; the reference had only
first-order characteristic BCs, SURVEY.md §4.4).

1. The direction-split DG operators reproduce the unsplit operators to
   machine precision under every BC kind (the exactness that makes the
   interior PML-free physics identical to the plain central-flux path).
2. With zero damping the memory fields stay identically zero (no drift
   leaks into the interior).
3. The headline: a C-PML reduces interior residual energy by >100x over
   characteristic BCs alone (measured ~1700x at build time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.cpml import (
    apply_grad_op_split,
    apply_vel_op_split,
    hooke_pointwise,
)
from seigen_jax.ops.elastic import apply_stress_op, apply_vel_op
from seigen_jax.solver import cfl_dt
from seigen_jax.solver.damping import absorbing_bc_fn
from seigen_jax.solver.pml import (
    cpml_init,
    cpml_profiles,
    make_cpml_rhs,
    run_cpml,
)

MAT = Material(rho=1.2, vp=2.0, vs=1.1)


@pytest.mark.parametrize("dim", [2, 3])
def test_split_operators_exact(dim):
    """Summed velocity split == apply_vel_op; Hooke of the split gradient
    == apply_stress_op — machine precision, mixed free/absorbing BCs."""
    mesh = rect_mesh(4, 4) if dim == 2 else box_mesh(2, 2, 2)
    ext = [(0.0, 1.0)] * dim
    dm = build_discrete(
        mesh, 3, bc_fn=absorbing_bc_fn(ext, [(dim - 1, "hi")]))
    p = build_params(dm, MAT, dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    n_sig = 3 if dim == 2 else 6
    rng = np.random.default_rng(0)
    s = jnp.asarray(rng.standard_normal((E, n_p, n_sig)))
    u = jnp.asarray(rng.standard_normal((E, n_p, dim)))
    v_split = p.inv_rho[:, None, None] * jnp.sum(
        apply_vel_op_split(p, s), axis=1)
    np.testing.assert_allclose(
        np.asarray(v_split), np.asarray(apply_vel_op(p, s)), atol=1e-12)
    s_split = hooke_pointwise(p, apply_grad_op_split(p, u))
    np.testing.assert_allclose(
        np.asarray(s_split), np.asarray(apply_stress_op(p, u)), atol=1e-12)


def test_zero_damping_keeps_memory_zero():
    """d = alpha = 0 everywhere: psi fields stay exactly zero, so the CPML
    stepper IS the plain central-flux method-of-lines in the interior."""
    dm = build_discrete(rect_mesh(4, 4, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    rng = np.random.default_rng(1)
    u0 = rng.standard_normal((E, n_p, 2))
    s0 = rng.standard_normal((E, n_p, 3))
    z = np.zeros((E, n_p, 2))
    rhs = make_cpml_rhs(p, z, z)
    st0 = cpml_init(p, jnp.asarray(u0), jnp.asarray(s0))
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.3)
    fin, _ = jax.jit(lambda st: run_cpml(p, st, dt, 10, rhs))(st0)
    assert float(jnp.abs(fin.pv).max()) == 0.0
    assert float(jnp.abs(fin.ps).max()) == 0.0
    assert np.isfinite(np.asarray(fin.u)).all()


def test_cpml_beats_characteristic_bc():
    """Pulse at the center of an all-absorbing box: after the waves leave,
    interior residual energy with a 0.25-wide C-PML is >100x below the
    characteristic-BC-only run (measured ratio 5.8e-4 at build time)."""
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    dm = build_discrete(
        rect_mesh(12, 12), 3, bc_fn=absorbing_bc_fn([(0.0, 1.0)] * 2, []))
    p = build_params(dm, mat, dtype=jnp.float64)
    E, n_p = dm.num_elements, dm.re.n_p
    co = dm.coords
    r2 = (co[..., 0] - 0.5) ** 2 + (co[..., 1] - 0.5) ** 2
    u0 = np.zeros((E, n_p, 2))
    u0[..., 1] = np.exp(-r2 / 0.01)
    s0 = np.zeros((E, n_p, 3))
    dt = cfl_dt(dm.h.min(), 2.0, 3, 0.35)
    n = int(np.ceil(1.0 / dt))
    dt = 1.0 / n
    interior = (
        (co[..., 0] > 0.3) & (co[..., 0] < 0.7)
        & (co[..., 1] > 0.3) & (co[..., 1] < 0.7)
    )
    sides = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi")]
    residual = {}
    for label, (d, a) in [
        ("chr", (np.zeros_like(co), np.zeros_like(co))),
        ("pml", cpml_profiles(dm, sides, 0.25, 2.0, f0=3.0)),
    ]:
        rhs = make_cpml_rhs(p, d, a)
        st0 = cpml_init(p, jnp.asarray(u0), jnp.asarray(s0))
        fin, _ = jax.jit(lambda st: run_cpml(p, st, dt, n, rhs))(st0)
        uf = np.asarray(fin.u)
        assert np.isfinite(uf).all()
        residual[label] = float((uf[interior] ** 2).sum())
    assert residual["pml"] < 0.01 * residual["chr"], residual
