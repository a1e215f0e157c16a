"""Curvilinear (isoparametric) elements — non-affine meshes.

Beyond-reference capability (ROADMAP "next rounds"; the reference's
production meshes are straight-sided simplices — Firedrake's default P1
coordinate field, SURVEY.md §2 "Mesh handling").  Curved geometry is
what topography, boreholes, and interior interfaces need; this module
supplies it in the device-friendly shape: per-element OPERATOR MATRICES,
so every application is a batched (n_p, n_p) matmul over the element
axis — exactly the MXU-friendly contraction pattern of the affine fast
paths, just with E-many small matrices instead of shared tables.

Formulation (isoparametric nodal DG, geometry degree = solution degree:
the geometry nodes ARE the solution nodes `dm.coords`, curved by a
smooth map):

  x(xi) = sum_a X_a l_a(xi)          J(xi) = dx/dxi  (varies per point)

  M_e     = Vq^T diag(w detJ(xi_q)) Vq                (true cubature)
  D_e^(d) = M_e^-1 Vq^T diag(w detJ) [sum_r Jinv_rd(xi_q) dVq_r]
  L_e^(f) = M_e^-1 Vfq_f^T diag(w_f sJ(s_q))          (curved-face lift)

with per-face-quadrature-point outward normals n(s_q) and surface
Jacobians sJ from the physical face tangents (orientation fixed by the
Nanson direction detJ J^-T n_ref).  Neighbour traces reuse the EXISTING
node-level gather (`ElasticParams.nbr` — matching is topological, so
curved conforming faces pair exactly like affine ones); the degree-q
face trace is interpolated node->face-quadrature exactly by the face
Lagrange basis.  BC flux coefficients (beta_t/delta_u) apply unchanged.

Affine limit: all quadratures are exact for straight elements, so the
curvilinear operators REPRODUCE the affine einsum operators to roundoff
(tests/test_curvilinear.py) — the affine path stays the production one;
this path prices only actually-curved meshes.

Variational crime note: volume cubature is exact to degree 2q+2
(refelem), while curved-geometry integrands are rational in xi; the
committed quadrature error is superconvergent relative to the O(h^q)
operator accuracy (standard isoparametric practice), and the
operator-level convergence test measures the realized order directly.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.discrete import DiscreteMesh
from ..refelem.tables import _eval_monomials, monomial_exponents
from .elastic import ElasticParams, _traces, voigt_map


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["De", "Lf", "Ff", "nrm_q", "X"],
    meta_fields=["dim", "n_p", "n_faces", "nfq", "n_sig"],
)
@dataclass(frozen=True)
class CurviParams:
    """Per-element curvilinear operator data (pytree)."""

    De: jax.Array  # (E, dim, n_p, n_p) strong physical derivative, Minv in
    Lf: jax.Array  # (E, n_faces, n_p, nfq) curved-face lift, Minv + sJ in
    Ff: jax.Array  # (n_faces, nfq, n_fp) face node -> face quad interp
    nrm_q: jax.Array  # (E, n_faces, nfq, dim) outward normals per point
    X: jax.Array  # (E, n_p, dim) physical (curved) node coordinates
    dim: int
    n_p: int
    n_faces: int
    nfq: int
    n_sig: int


def _ref_face_maps(re):
    """Per-face (V0, T) param->ref affine maps and outward ref normals."""
    verts = re.vertices  # (dim+1, dim)
    dim = re.dim
    out = []
    for f in range(re.n_faces):
        fv = verts[re.face_vertices[f]]  # (dim, dim)
        V0 = fv[0]
        T = (fv[1:] - V0).T  # (dim, fdim)
        # outward reference normal: orthogonal to the face span, pointing
        # away from the opposite vertex
        if dim == 2:
            t = T[:, 0]
            n = np.array([t[1], -t[0]])
        else:
            n = np.cross(T[:, 0], T[:, 1])
        n = n / np.linalg.norm(n)
        opp = verts[f]  # face f is opposite vertex f
        if np.dot(n, opp - V0) > 0:
            n = -n
        out.append((V0, T, n))
    return out


def build_curvi(dm: DiscreteMesh, X: np.ndarray,
                dtype=jnp.float32) -> CurviParams:
    """Per-element curvilinear operator data from curved node coords
    ``X`` (E, n_p, dim) — e.g. a smooth map applied to ``dm.coords``.

    Host-side numpy/f64 (setup-time, like the rest of build_discrete);
    cast to ``dtype`` at the end.
    """
    re = dm.re
    dim, n_p, nf = re.dim, re.n_p, re.n_faces
    E = dm.num_elements
    X = np.asarray(X, np.float64)
    if X.shape != (E, n_p, dim):
        raise ValueError(f"X must be (E, n_p, dim) = {(E, n_p, dim)}")

    # --- volume: J, detJ, Jinv at the volume cubature points ---
    # J[e, q, d, r] = d x_d / d xi_r
    Jq = np.einsum("rqa,ead->eqdr", re.Vq_grad, X)
    detJq = np.linalg.det(Jq)  # (E, nq)
    if detJq.min() <= 0:
        raise ValueError("curved mapping folds elements (detJ <= 0); "
                         "reduce the curvature amplitude")
    Jinvq = np.linalg.inv(Jq)  # (E, nq, r, d): d xi_r / d x_d
    wdet = re.qw[None, :] * detJq  # (E, nq)

    M = np.einsum("qi,eq,qj->eij", re.Vq, wdet, re.Vq)
    Minv = np.linalg.inv(M)

    # D_e^(d): strong physical derivative projected back to nodal coeffs
    # W[e, d, q, j] = d l_j / d x_d at xi_q
    W = np.einsum("eqrd,rqj->edqj", Jinvq, re.Vq_grad)
    P = np.einsum("qi,eq,edqj->edij", re.Vq, wdet, W)
    De = np.einsum("eik,edkj->edij", Minv, P)

    # --- faces: tangents, surface Jacobian, outward normals, lift ---
    fdim = max(dim - 1, 1)
    nfq = re.fq_x.shape[0]
    fexps = monomial_exponents(fdim, re.degree)
    Lf = np.zeros((E, nf, n_p, nfq))
    nrm_q = np.zeros((E, nf, nfq, dim))
    Ff = np.zeros((nf, nfq, re.n_fp))
    for f, (V0, T, nref) in enumerate(_ref_face_maps(re)):
        vol_pts = V0 + re.fq_x @ T.T  # (nfq, dim) ref coords of face quad
        Gf = re.eval_basis_grad(vol_pts)  # (dim, nfq, n_p)
        # physical tangents wrt the face PARAMETER coords:
        # tg[e, q, d, k] = sum_a X[e,a,d] sum_r Gf[r,q,a] T[r,k]
        GT = np.einsum("rqa,rk->qak", Gf, T)  # (nfq, n_p, fdim)
        tg = np.einsum("ead,qak->eqdk", X, GT)
        if dim == 2:
            t = tg[..., 0]  # (E, nfq, 2)
            nvec = np.stack([t[..., 1], -t[..., 0]], axis=-1)
        else:
            nvec = np.cross(tg[..., 0], tg[..., 1])
        sJ = np.linalg.norm(nvec, axis=-1)  # (E, nfq)
        # orientation: Nanson direction detJ J^-T n_ref is outward
        Jf = np.einsum("rqa,ead->eqdr", Gf, X)
        ndir = np.einsum("eq,eqrd,r->eqd", np.linalg.det(Jf),
                         np.linalg.inv(Jf), nref)
        sgn = np.sign(np.einsum("eqd,eqd->eq", nvec, ndir))
        if np.any(sgn == 0):
            raise ValueError("degenerate face normal on curved face")
        nvec = nvec * sgn[..., None]
        nrm_q[:, f] = nvec / sJ[..., None]
        # lift: Minv Vfq^T diag(w_f sJ)
        Lf[:, f] = np.einsum(
            "eik,qk,eq->eiq", Minv, re.Vfq[f],
            re.fq_w[None, :] * sJ)
        # face node -> face quadrature interpolation (exact for degree q)
        Af = _eval_monomials(fexps, re.face_param_nodes[f])
        Ff[f] = _eval_monomials(fexps, re.fq_x) @ np.linalg.inv(Af)

    as_ = lambda a: jnp.asarray(a, dtype)
    return CurviParams(
        De=as_(De), Lf=as_(Lf), Ff=as_(Ff), nrm_q=as_(nrm_q), X=as_(X),
        dim=dim, n_p=n_p, n_faces=nf, nfq=nfq, n_sig=3 if dim == 2 else 6)


def curved_coords(dm: DiscreteMesh, mapping) -> np.ndarray:
    """Apply a smooth coordinate map to the mesh's node coordinates.

    ``mapping``: (N, dim) -> (N, dim).  Applying the SAME map to every
    element's nodes keeps conforming faces conforming (shared physical
    points stay shared), so the topological neighbour gather is
    untouched."""
    E, n_p, dim = dm.coords.shape
    return np.asarray(mapping(dm.coords.reshape(-1, dim))).reshape(
        E, n_p, dim)


# --- operators (signature-compatible with make_step's vel_op/stress_op) --
def curvi_vel_op(cp: CurviParams, p: ElasticParams, sigma, pool=None,
                 traces=None):
    """(1/rho) div(sigma) on curved elements: batched per-element
    derivative matmuls + curved-face central flux."""
    V = voigt_map(p.dim)
    dim = p.dim
    g = jnp.einsum("edij,ejs->edis", cp.De, sigma)  # (E, dim, n_p, n_sig)
    div = jnp.stack(
        [sum(g[:, d, :, V[c, d]] for d in range(dim)) for c in range(dim)],
        axis=-1)  # (E, n_p, dim)

    own, nbr = _traces(p, sigma, pool, traces)  # (E, nf, nfp, n_sig)
    own_q = jnp.einsum("fqk,efks->efqs", cp.Ff, own)
    nbr_q = jnp.einsum("fqk,efks->efqs", cp.Ff, nbr)
    nrm = cp.nrm_q  # (E, nf, nfq, dim)
    t_own = jnp.stack(
        [sum(nrm[..., d] * own_q[..., V[c, d]] for d in range(dim))
         for c in range(dim)], axis=-1)
    t_nbr = jnp.stack(
        [sum(nrm[..., d] * nbr_q[..., V[c, d]] for d in range(dim))
         for c in range(dim)], axis=-1)
    jump = 0.5 * t_nbr + p.beta_t[:, :, None, None] * t_own
    surf = jnp.einsum("efiq,efqc->eic", cp.Lf, jump)
    return p.inv_rho[:, None, None] * (div + surf)


def curvi_stress_op(cp: CurviParams, p: ElasticParams, u, pool=None,
                    traces=None):
    """Hooke(sym grad u) on curved elements (isotropic lam/mu)."""
    dim = p.dim
    g = jnp.einsum("edij,ejc->edic", cp.De, u)  # g[e,d,:,c] = du_c/dx_d
    lam = p.lam[:, None]
    mu = p.mu[:, None]
    divu = sum(g[:, d, :, d] for d in range(dim))
    vol = [lam * divu + 2.0 * mu * g[:, c, :, c] for c in range(dim)]
    if dim == 2:
        vol.append(mu * (g[:, 1, :, 0] + g[:, 0, :, 1]))
    else:
        vol.append(mu * (g[:, 2, :, 1] + g[:, 1, :, 2]))
        vol.append(mu * (g[:, 2, :, 0] + g[:, 0, :, 2]))
        vol.append(mu * (g[:, 1, :, 0] + g[:, 0, :, 1]))
    vol = jnp.stack(vol, axis=-1)  # (E, n_p, n_sig)

    own, nbr = _traces(p, u, pool, traces)  # (E, nf, nfp, dim)
    own_q = jnp.einsum("fqk,efkc->efqc", cp.Ff, own)
    nbr_q = jnp.einsum("fqk,efkc->efqc", cp.Ff, nbr)
    du = 0.5 * nbr_q + p.delta_u[:, :, None, None] * own_q
    nrm = cp.nrm_q
    lamf = p.lam[:, None, None]
    muf = p.mu[:, None, None]
    ndu = sum(nrm[..., d] * du[..., d] for d in range(dim))
    comps = [lamf * ndu + 2.0 * muf * nrm[..., c] * du[..., c]
             for c in range(dim)]
    if dim == 2:
        comps.append(muf * (nrm[..., 0] * du[..., 1]
                            + nrm[..., 1] * du[..., 0]))
    else:
        comps.append(muf * (nrm[..., 1] * du[..., 2]
                            + nrm[..., 2] * du[..., 1]))
        comps.append(muf * (nrm[..., 0] * du[..., 2]
                            + nrm[..., 2] * du[..., 0]))
        comps.append(muf * (nrm[..., 0] * du[..., 1]
                            + nrm[..., 1] * du[..., 0]))
    face = jnp.stack(comps, axis=-1)  # (E, nf, nfq, n_sig)
    surf = jnp.einsum("efiq,efqs->eis", cp.Lf, face)
    return vol + surf


def make_curvi_ops(cp: CurviParams):
    """(vel_op, stress_op) closures plugging into make_step/run."""
    return (lambda p, s, pool=None, traces=None:
            curvi_vel_op(cp, p, s, pool, traces),
            lambda p, u, pool=None, traces=None:
            curvi_stress_op(cp, p, u, pool, traces))
