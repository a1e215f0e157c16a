"""Reference-element tables for nodal DG on simplices (P1-P8, tri/tet).

This module replaces the reference stack's form-compiler layer (SURVEY.md §2
layers 4-5: UFL -> TSFC/COFFEE generated C kernels).  Instead of generating
per-form C code, we precompute dense reference-element operator tables once on
the host in float64 and apply them on the device as batched matmuls:

  - ``Dr[r]``   : strong-form nodal differentiation matrices d/dxi_r
  - ``LIFT``    : Minv @ E, mapping face-node flux values to volume-node
                  residual contributions (Hesthaven-Warburton style)
  - ``fnodes``  : volume-node indices on each face (traces of the nodal basis)

Construction is deliberately simple and verifiable: equispaced nodal points,
monomial Vandermonde inversion (quadrature-orthonormalized working basis past
P4, where the raw monomial Vandermonde becomes too ill-conditioned), and
collapsed Gauss-Jacobi quadrature that is exact for every integral appearing
here.  Unit tests check mass/stiffness
matrices against sympy exact integration and the discrete integration-by-parts
identity M @ Dr + Dr^T @ M == sum_f n_f,r * E_f (tests/test_refelem.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import scipy.linalg

from .quadrature import simplex_quadrature

__all__ = ["RefElem", "ref_elem", "monomial_exponents"]


def monomial_exponents(dim: int, degree: int) -> np.ndarray:
    """All exponent tuples of total degree <= degree, in a fixed order."""
    exps = [
        e
        for e in itertools.product(range(degree + 1), repeat=dim)
        if sum(e) <= degree
    ]
    exps.sort()
    return np.array(exps, dtype=np.int64)


def _eval_monomials(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(npts, nmono) monomial values."""
    # pts: (npts, dim)
    out = np.ones((pts.shape[0], exps.shape[0]))
    for d in range(pts.shape[1]):
        out *= pts[:, d : d + 1] ** exps[None, :, d]
    return out


def _eval_monomial_grad(exps: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(dim, npts, nmono) monomial derivative values."""
    dim = pts.shape[1]
    out = np.zeros((dim, pts.shape[0], exps.shape[0]))
    for r in range(dim):
        vals = np.ones((pts.shape[0], exps.shape[0]))
        for d in range(dim):
            e = exps[:, d].astype(np.float64)
            if d == r:
                # d/dx x^e = e * x^(e-1); exponent 0 rows contribute 0.
                em1 = np.maximum(exps[:, d] - 1, 0)
                vals *= e[None, :] * pts[:, d : d + 1] ** em1[None, :]
            else:
                vals *= pts[:, d : d + 1] ** exps[None, :, d]
        out[r] = vals
    return out


def _simplex_vertices(dim: int) -> np.ndarray:
    """Unit reference simplex vertices: origin + unit basis vectors."""
    v = np.zeros((dim + 1, dim))
    for d in range(dim):
        v[d + 1, d] = 1.0
    return v


def _equispaced_nodes(dim: int, degree: int) -> np.ndarray:
    """Equispaced nodal set on the unit simplex, lexicographically ordered.

    For q<=4 the equispaced set is well-conditioned enough (monomial
    Vandermonde cond ~1e4 in f64; tables verified to ~1e-11 by unit tests).
    """
    if degree == 0:
        return np.full((1, dim), 1.0 / (dim + 1))
    pts = []
    for e in itertools.product(range(degree + 1), repeat=dim):
        if sum(e) <= degree:
            pts.append([ei / degree for ei in e])
    pts.sort()
    return np.array(pts, dtype=np.float64)


@dataclass(frozen=True)
class RefElem:
    """Immutable reference-element table set (host-side float64)."""

    dim: int
    degree: int
    n_p: int  # nodes per element
    n_faces: int
    n_fp: int  # nodes per face
    nodes: np.ndarray  # (n_p, dim)
    face_vertices: np.ndarray  # (n_faces, dim) vertex ids per face
    vertices: np.ndarray  # (dim+1, dim) reference simplex vertices
    M: np.ndarray  # (n_p, n_p) reference mass
    Minv: np.ndarray  # (n_p, n_p)
    Dr: np.ndarray  # (dim, n_p, n_p) strong nodal derivative d/dxi_r
    LIFT: np.ndarray  # (n_p, n_faces * n_fp) Minv @ E (param-measure faces)
    fnodes: np.ndarray  # (n_faces, n_fp) volume-node ids on each face
    face_param_nodes: np.ndarray  # (n_faces, n_fp, max(dim-1,1)) param coords
    # quadrature for errors/projections
    qx: np.ndarray  # (nq, dim)
    qw: np.ndarray  # (nq,)
    Vq: np.ndarray  # (nq, n_p) nodal basis at quadrature points
    Vq_grad: np.ndarray  # (dim, nq, n_p)
    # face quadrature (on the face parameter simplex)
    fq_x: np.ndarray  # (nfq, max(dim-1,1))
    fq_w: np.ndarray  # (nfq,)
    Vfq: np.ndarray  # (n_faces, nfq, n_p) volume basis at face quad points
    # helpers
    _mono_exps: np.ndarray = field(repr=False)
    _Ainv: np.ndarray = field(repr=False)

    def eval_basis(self, pts: np.ndarray) -> np.ndarray:
        """Nodal (Lagrange) basis values at arbitrary points: (npts, n_p)."""
        return _eval_monomials(self._mono_exps, np.atleast_2d(pts)) @ self._Ainv

    def eval_basis_grad(self, pts: np.ndarray) -> np.ndarray:
        """(dim, npts, n_p) reference-coordinate gradients at points."""
        g = _eval_monomial_grad(self._mono_exps, np.atleast_2d(pts))
        return np.einsum("rpm,mn->rpn", g, self._Ainv)


def _face_vertex_ids(dim: int) -> np.ndarray:
    """Face i is opposite vertex i (vertices of the face = all but i)."""
    ids = []
    for i in range(dim + 1):
        ids.append([j for j in range(dim + 1) if j != i])
    return np.array(ids, dtype=np.int64)


def _orthonormalized_nodal_inverse(
    exps: np.ndarray, nodes: np.ndarray, dim: int, degree: int
) -> np.ndarray:
    """Composite coefficient map `Ainv` with `mono(pts) @ Ainv` = nodal basis.

    Orthonormalizes the monomial span against the volume-quadrature inner
    product (QR of sqrt(w)-weighted monomial values), then inverts the nodal
    Vandermonde of the ORTHONORMAL basis — conditioning drops from the
    monomial Vandermonde's ~1e9 (3D P6, equispaced) to the Lebesgue level.
    """
    qx, qw = simplex_quadrature(dim, 2 * degree + 2)
    Phi = _eval_monomials(exps, qx)  # (nq, n_p)
    _, R = np.linalg.qr(np.sqrt(qw)[:, None] * Phi)
    # Fix QR sign ambiguity for determinism across BLAS builds.
    s = np.sign(np.diag(R))
    s[s == 0] = 1.0
    R = s[:, None] * R
    Rinv = scipy.linalg.solve_triangular(R, np.eye(R.shape[0]))
    P_nodes = _eval_monomials(exps, nodes) @ Rinv  # orthonormal basis at nodes
    return Rinv @ np.linalg.inv(P_nodes)


_CACHE: dict[tuple[int, int], RefElem] = {}


def ref_elem(dim: int, degree: int) -> RefElem:
    """Build (and cache) the reference-element table set."""
    key = (dim, degree)
    if key in _CACHE:
        return _CACHE[key]

    if dim not in (2, 3):
        raise ValueError("dim must be 2 or 3")
    if not (1 <= degree <= 8):
        raise ValueError(
            "degree must be in 1..8 (P1-P4 = reference parity; P5-P8 = "
            "beyond-parity high-order elements)"
        )

    exps = monomial_exponents(dim, degree)
    nodes = _equispaced_nodes(dim, degree)
    n_p = nodes.shape[0]
    assert exps.shape[0] == n_p

    if degree <= 4:
        A = _eval_monomials(exps, nodes)  # (n_p, n_p)
        Ainv = np.linalg.inv(A)
    else:
        # Past P4 the raw monomial Vandermonde at equispaced nodes is too
        # ill-conditioned (cond ~1e9 at 3D P6) to invert directly, so work
        # in a quadrature-orthonormalized basis: weighted QR of the
        # monomials at the volume quadrature gives p = mono @ Rinv with
        # \int p_i p_j = delta_ij, and the composite Ainv = Rinv @
        # inv(p(nodes)) keeps every downstream `mono(pts) @ Ainv` identity
        # (eval_basis, Vq, Dr, M = Ainv^T G Ainv) intact while the matrix
        # actually inverted is well-conditioned.  P1-P4 keep the original
        # path bit-for-bit (validated tables; warm .jax_cache programs).
        Ainv = _orthonormalized_nodal_inverse(exps, nodes, dim, degree)

    # Volume quadrature, exact for 2*degree integrands with margin.
    qx, qw = simplex_quadrature(dim, 2 * degree + 2)
    Vq = _eval_monomials(exps, qx) @ Ainv
    Vq_grad = np.einsum("rpm,mn->rpn", _eval_monomial_grad(exps, qx), Ainv)

    M = Vq.T @ (qw[:, None] * Vq)
    Minv = np.linalg.inv(M)

    # Strong nodal differentiation matrices: (Dr f)_i = d f_h / d xi_r (x_i)
    Dr = np.einsum("rpm,mn->rpn", _eval_monomial_grad(exps, nodes), Ainv)

    # ---- faces ----
    verts = _simplex_vertices(dim)
    fverts = _face_vertex_ids(dim)
    n_faces = dim + 1
    fdim = dim - 1

    # face quadrature on the (dim-1) parameter simplex, exact for 2*degree
    fq_x, fq_w = simplex_quadrature(max(fdim, 1), 2 * degree + 2)
    nfq = fq_x.shape[0]

    fnodes_list = []
    fparam_list = []
    Vfq = np.zeros((n_faces, nfq, n_p))
    E = None  # assembled below once n_fp is known

    tol = 1e-12
    for f in range(n_faces):
        V = verts[fverts[f]]  # (dim, dim): face vertices
        V0 = V[0]
        T = (V[1:] - V0).T  # (dim, fdim): param -> ref map
        # nodes on this face: those whose barycentric coord wrt opposite
        # vertex is 0, i.e. solve least squares for param coords and check.
        coords, *_ = np.linalg.lstsq(T, (nodes - V0).T, rcond=None)
        coords = coords.T  # (n_p, fdim)
        recon = V0 + coords @ T.T
        on_face = np.linalg.norm(recon - nodes, axis=1) < tol
        in_simplex = (coords.min(axis=1) > -tol) & (coords.sum(axis=1) < 1 + tol)
        ids = np.where(on_face & in_simplex)[0]
        fp = coords[ids]
        order = np.lexsort(fp.T[::-1]) if fdim > 0 else np.array([0])
        ids = ids[order]
        fp = fp[order]
        fnodes_list.append(ids)
        fparam_list.append(fp)
        # volume basis at face quadrature points (mapped into the volume)
        vol_pts = V0 + fq_x @ T.T
        Vfq[f] = _eval_monomials(exps, vol_pts) @ Ainv

    fnodes = np.array(fnodes_list, dtype=np.int64)
    n_fp = fnodes.shape[1]
    face_param_nodes = np.array(fparam_list)

    # Face Lagrange basis on the face parameter simplex (equispaced on it).
    fexps = monomial_exponents(max(fdim, 1), degree)
    # E0_f[k', k] = \int_param ellf_k' ellf_k  (no measure factor; physical
    # face area enters through Fscale = sJ_phys / |detJ| in geometry.py).
    E = np.zeros((n_p, n_faces * n_fp))
    for f in range(n_faces):
        fp = face_param_nodes[f]
        if fdim == 0:
            Mf0 = np.ones((1, 1))
        else:
            if degree <= 4:
                Afinv = np.linalg.inv(_eval_monomials(fexps, fp))
            else:
                Afinv = _orthonormalized_nodal_inverse(fexps, fp, fdim, degree)
            Vfq_face = _eval_monomials(fexps, fq_x) @ Afinv  # (nfq, n_fp)
            Mf0 = Vfq_face.T @ (fq_w[:, None] * Vfq_face)
        for kp in range(n_fp):
            E[fnodes[f, kp], f * n_fp : (f + 1) * n_fp] = Mf0[kp]

    LIFT = Minv @ E

    elem = RefElem(
        dim=dim,
        degree=degree,
        n_p=n_p,
        n_faces=n_faces,
        n_fp=n_fp,
        nodes=nodes,
        face_vertices=fverts,
        vertices=verts,
        M=M,
        Minv=Minv,
        Dr=Dr,
        LIFT=LIFT,
        fnodes=fnodes,
        face_param_nodes=face_param_nodes,
        qx=qx,
        qw=qw,
        Vq=Vq,
        Vq_grad=Vq_grad,
        fq_x=fq_x,
        fq_w=fq_w,
        Vfq=Vfq,
        _mono_exps=exps,
        _Ainv=Ainv,
    )
    _CACHE[key] = elem
    return elem
