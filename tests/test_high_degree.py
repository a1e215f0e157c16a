"""High-order elements (P5/P6) — beyond-parity coverage.

The reference stack ran P1-P4 (SURVEY.md §4.2: production degree sweep
q in {1..4}); this rebuild's table generator is degree-parametric, so P5+
come almost for free once the nodal basis is built in a well-conditioned
way (quadrature-orthonormalized working basis, refelem/tables.py).

Covers: einsum-path spectral-ish convergence at P5 (2D sweep + 3D case)
and einsum-twin equivalence of the roll-exchange engine at P5 (the
fused kernel covers P1-P4 only; ops/select.py sends P5+ to XLA).  The refelem
identity tests (mass-vs-sympy, discrete IBP, face traces) run at P5/P6
via the widened parametrization in test_refelem.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.structured_exchange import detect_structured
from seigen_jax.solver import (
    PlaneWave,
    State,
    cfl_dt,
    convergence_order,
    interpolate,
    l2_error,
    run,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _eigenmode_error(dm, pw, T, cfl=0.3):
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), float(np.asarray(MAT.vp)), dm.re.degree, cfl)
    n = max(int(np.ceil(T / dt)), 1)
    dt = T / n
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    fin, _ = jax.jit(lambda p, st: run(p, st, dt, n, order=4))(p, st)
    return l2_error(dm, np.asarray(fin.u), pw.u, n * dt)


def test_eigenmode2d_p5_convergence():
    """P5 spatial convergence beats order 5 on a 2-point h-sweep.

    Measured at build time: errors 1.23e-2 / 9.87e-4 / 3.74e-5 at
    N=2/3/4 (order 6.2 then superconvergent) — asserting the N=2->3 pair
    keeps the test cheap while pinning the high-order behavior.
    """
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    errs, hs = [], []
    for N in (2, 3):
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), 5)
        errs.append(_eigenmode_error(dm, pw, pw.period))
        hs.append(1.0 / N)
    assert convergence_order(hs, errs) > 5.0, errs
    assert errs[-1] < 0.15 * errs[0]


def test_eigenmode3d_p5_accuracy():
    """3D P5 on a 2-cube periodic box: quarter-period error stays tiny
    (measured 3.2e-4 at build time; a sign/table bug would be O(1))."""
    pw = PlaneWave(
        mat=MAT, k=2 * np.pi * np.array([1.0, 0.0, 0.0]), mode="S",
        polarization=np.array([0.0, 1.0, 0.0]))
    dm = build_discrete(box_mesh(2, 2, 2, periodic=(0, 1, 2)), 5)
    err = _eigenmode_error(dm, pw, pw.period / 4)
    assert err < 2e-3, err


def test_fast_engines_p5_equivalence():
    """The roll-exchange engine at P5 == einsum oracle (periodic 2D), and
    auto keeps P5 on the XLA operators even on a GPU."""
    from seigen_jax.ops.select import XLA_STRUCTURED, choose_impl, make_ops

    dm = build_discrete(rect_mesh(4, 4, periodic=(0, 1)), 5)
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    p = build_params(dm, MAT, dtype=jnp.float32)
    ex = detect_structured(dm)
    assert ex is not None
    dt = cfl_dt(dm.h.min(), 2.0, 5, 0.4)
    n = 3
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0), jnp.float32),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt), jnp.float32),
    )
    ref, _ = jax.jit(lambda p, st: run(p, st, dt, n, order=4))(p, st)
    assert choose_impl("gpu", True, dim=2, degree=5) == XLA_STRUCTURED
    vo, so = make_ops("xla_roll", p, dm)
    out, _ = jax.jit(lambda p, st: run(p, st, dt, n, order=4, vel_op=vo,
                                       stress_op=so))(p, st)
    np.testing.assert_allclose(
        np.asarray(out.u), np.asarray(ref.u), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(out.s), np.asarray(ref.s), rtol=2e-4, atol=2e-5)
