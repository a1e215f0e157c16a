"""Quadrature rules on the reference unit simplex (triangle / tetrahedron).

Built from collapsed tensor-product Gauss-Legendre / Gauss-Jacobi rules, so the
rules are exact for polynomials up to a requested total degree and available at
any order.  Everything here is host-side NumPy float64; these rules are used
only at setup time (building element tables, computing L2 errors) — never on
the device hot path.

Reference parity: the reference stack (Firedrake/TSFC) picks quadrature degrees
automatically per UFL form (SURVEY.md §2 layer 4); here we expose
`tri_quadrature(deg)` / `tet_quadrature(deg)` with an explicit exactness degree
and unit-test monomial exactness (tests/test_refelem.py).
"""

from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_jacobi01(n: int, alpha: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule on [0,1] with weight (1-x)^alpha.

    scipy's roots_jacobi is on [-1,1] with weight (1-x)^a (1+x)^b; mapping
    x01 = (x+1)/2 gives weight ((1-x01)*2)^a * dx-scale 1/2 ⇒ total scale
    2^(-1-alpha).
    """
    x, w = roots_jacobi(n, alpha, 0.0)
    return 0.5 * (x + 1.0), w * (0.5 ** (1 + alpha))


def interval_quadrature(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Rule on [0,1] exact for polynomials of degree `degree`."""
    n = degree // 2 + 1
    x, w = gauss_legendre(n)
    return x.reshape(-1, 1), w


def tri_quadrature(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Rule on the unit triangle {x,y>=0, x+y<=1} exact to total degree `degree`.

    Collapsed coordinates: x = a(1-b), y = b with a,b in [0,1]^2 and
    dx dy = (1-b) da db.  The (1-b) factor is absorbed into a Gauss-Jacobi
    rule in b, keeping polynomial exactness clean.
    Returns (points (nq,2), weights (nq,)); weights sum to 1/2.
    """
    n = degree // 2 + 1
    a, wa = gauss_legendre(n)
    b, wb = gauss_jacobi01(n, 1)
    A, B = np.meshgrid(a, b, indexing="ij")
    WA, WB = np.meshgrid(wa, wb, indexing="ij")
    x = A * (1.0 - B)
    y = B
    w = WA * WB
    return np.stack([x.ravel(), y.ravel()], axis=1), w.ravel()


def tet_quadrature(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Rule on the unit tetrahedron exact to total degree `degree`.

    Collapsed: x = a(1-b)(1-c), y = b(1-c), z = c; Jacobian (1-b)(1-c)^2.
    Weights sum to 1/6.
    """
    n = degree // 2 + 1
    a, wa = gauss_legendre(n)
    b, wb = gauss_jacobi01(n, 1)
    c, wc = gauss_jacobi01(n, 2)
    A, B, C = np.meshgrid(a, b, c, indexing="ij")
    WA, WB, WC = np.meshgrid(wa, wb, wc, indexing="ij")
    x = A * (1.0 - B) * (1.0 - C)
    y = B * (1.0 - C)
    z = C
    w = WA * WB * WC
    return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1), w.ravel()


def simplex_quadrature(dim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    if dim == 1:
        return interval_quadrature(degree)
    if dim == 2:
        return tri_quadrature(degree)
    if dim == 3:
        return tet_quadrature(degree)
    raise ValueError(f"unsupported dim {dim}")
