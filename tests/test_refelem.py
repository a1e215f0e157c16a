"""Unit tests for reference-element tables (SURVEY.md §6 rebuild test plan #1).

These are the rebuild's analog of trusting TSFC-generated kernels in the
reference: every table used on the device hot path is checked here against exact
(sympy) integration and discrete identities.
"""

import itertools

import numpy as np
import pytest
import sympy as sp

from seigen_jax.refelem import ref_elem, simplex_quadrature
from seigen_jax.refelem.tables import monomial_exponents

# P1-P4 = reference parity; P5-P6 = beyond-parity high-order elements
# (quadrature-orthonormalized nodal basis past P4 — see refelem/tables.py).
DIMS_DEGREES = [(d, q) for d in (2, 3) for q in (1, 2, 3, 4, 5, 6)]


def _exact_simplex_monomial(exps):
    """Exact integral of x^a y^b (z^c) over the unit simplex via sympy."""
    # \int x^a y^b z^c = a! b! c! / (a+b+c+dim)!
    from math import factorial

    dim = len(exps)
    num = 1
    for e in exps:
        num *= factorial(int(e))
    return num / factorial(int(sum(exps)) + dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree", [1, 3, 6, 9])
def test_quadrature_monomial_exactness(dim, degree):
    qx, qw = simplex_quadrature(dim, degree)
    for exps in itertools.product(range(degree + 1), repeat=dim):
        if sum(exps) > degree:
            continue
        val = np.sum(qw * np.prod(qx ** np.array(exps), axis=1))
        exact = _exact_simplex_monomial(exps)
        assert abs(val - exact) < 1e-14 * max(1.0, abs(exact)), exps


@pytest.mark.parametrize("dim,degree", DIMS_DEGREES)
def test_mass_matrix_vs_sympy(dim, degree):
    """Mass matrix entries equal exact integrals of Lagrange basis products."""
    re = ref_elem(dim, degree)
    exps = monomial_exponents(dim, degree)
    # Exact integral of monomial products via the factorial formula, pushed
    # through the Lagrange coefficients: M = Ainv^T G Ainv with
    # G[m,n] = \int mono_m mono_n exact.
    n = exps.shape[0]
    G = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            G[i, j] = _exact_simplex_monomial(exps[i] + exps[j])
    M_exact = re._Ainv.T @ G @ re._Ainv
    assert np.allclose(re.M, M_exact, atol=1e-11)
    # Row sums of M = integral of each basis fn; total = simplex volume.
    vol = 0.5 if dim == 2 else 1.0 / 6.0
    assert abs(re.M.sum() - vol) < 1e-12


@pytest.mark.parametrize("dim,degree", DIMS_DEGREES)
def test_derivative_matrices_exact_on_polynomials(dim, degree):
    """Dr differentiates any degree-q polynomial exactly at the nodes."""
    re = ref_elem(dim, degree)
    rng = np.random.default_rng(0)
    exps = monomial_exponents(dim, degree)
    coef = rng.normal(size=exps.shape[0])

    def poly(pts):
        out = np.zeros(pts.shape[0])
        for c, e in zip(coef, exps):
            out += c * np.prod(pts ** np.array(e), axis=1)
        return out

    def dpoly(pts, r):
        out = np.zeros(pts.shape[0])
        for c, e in zip(coef, exps):
            if e[r] == 0:
                continue
            e2 = np.array(e, dtype=float)
            e2[r] -= 1
            out += c * e[r] * np.prod(pts**e2, axis=1)
        return out

    f = poly(re.nodes)
    for r in range(dim):
        assert np.allclose(re.Dr[r] @ f, dpoly(re.nodes, r), atol=1e-9)


def _ref_face_geometry(re, f):
    """Unit outward normal and measure scale of reference face f."""
    V = re.vertices[re.face_vertices[f]]
    opp = re.vertices[f]
    if re.dim == 2:
        t = V[1] - V[0]
        n = np.array([t[1], -t[0]])
        scale = np.linalg.norm(t)
    else:
        t1, t2 = V[1] - V[0], V[2] - V[0]
        n = np.cross(t1, t2)
        scale = np.linalg.norm(n)
    n = n / np.linalg.norm(n)
    if np.dot(n, V[0] - opp) < 0:
        n = -n
    return n, scale


@pytest.mark.parametrize("dim,degree", DIMS_DEGREES)
def test_integration_by_parts_identity(dim, degree):
    """M Dr + Dr^T M == sum_f n_f,r * scale_f * E0_f (discrete IBP).

    This jointly validates the mass matrix, the derivative matrices, the face
    node identification, and the face mass matrices — i.e. every ingredient of
    the strong-form DG operator.
    """
    re = ref_elem(dim, degree)
    # Reassemble per-face boundary mass in volume indexing from LIFT:
    # E = M @ LIFT.
    E = re.M @ re.LIFT
    for r in range(dim):
        lhs = re.M @ re.Dr[r] + re.Dr[r].T @ re.M
        rhs = np.zeros_like(lhs)
        for f in range(re.n_faces):
            nrm, scale = _ref_face_geometry(re, f)
            Ef = np.zeros_like(lhs)
            block = E[:, f * re.n_fp : (f + 1) * re.n_fp]  # (n_p, n_fp)
            for k in range(re.n_fp):
                Ef[:, re.fnodes[f, k]] += block[:, k]
            rhs += nrm[r] * scale * Ef
        assert np.allclose(lhs, rhs, atol=1e-9), (dim, degree, r)


@pytest.mark.parametrize("dim,degree", DIMS_DEGREES)
def test_face_trace_property(dim, degree):
    """Off-face basis functions vanish identically on the face (trace test)."""
    re = ref_elem(dim, degree)
    for f in range(re.n_faces):
        onf = set(re.fnodes[f].tolist())
        # Vfq[f] : volume basis at face quadrature points
        for i in range(re.n_p):
            vals = re.Vfq[f][:, i]
            if i in onf:
                continue
            assert np.max(np.abs(vals)) < 1e-9


@pytest.mark.parametrize("dim,degree", DIMS_DEGREES)
def test_eval_basis_partition_of_unity(dim, degree):
    re = ref_elem(dim, degree)
    rng = np.random.default_rng(1)
    # random points inside the simplex via dirichlet barycentric coords
    bary = rng.dirichlet(np.ones(dim + 1), size=20)
    pts = bary @ re.vertices
    B = re.eval_basis(pts)
    assert np.allclose(B.sum(axis=1), 1.0, atol=1e-10)
    # nodal property
    Bn = re.eval_basis(re.nodes)
    assert np.allclose(Bn, np.eye(re.n_p), atol=1e-9)
