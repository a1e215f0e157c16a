"""Anisotropic elasticity: per-element Voigt stiffness tensors.

Beyond-reference capability (the reference is isotropic lam/mu only;
anisotropy — VTI shales, HTI fractures — is a production-seismology
staple).  The DG operators need no structural change: both the volume and
face terms of the stress operator are C : sym(a (x) b) (a = gradient /
face normal, b = velocity / velocity jump), so general anisotropy is the
same einsum with an (E, n_sig, n_sig) stiffness C instead of the
isotropic two-parameter C(lam, mu).  The velocity operator involves only
rho and is unchanged; BC/penalty flux coefficients (beta_t/delta_u)
retain the standard central-flux penalty structure.

Conventions: Voigt with ENGINEERING shear strains (gamma = 2 eps), so C
is the standard symmetric Voigt matrix; 3D order (xx, yy, zz, yz, xz,
xy), 2D order (xx, yy, xy) — matching ops/elastic.py voigt_map.

Central-flux LF2/LF4 path (the upwind Riemann solver is
isotropy-specific).  Oracle: iso_stiffness reproduces apply_stress_op
exactly (tests/test_anisotropic.py); an SH plane wave in a VTI medium
propagates at sqrt(C55/rho), not sqrt(mu/rho).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .elastic import ElasticParams, _lift, _phys_grad, _traces, n_sig_for


def iso_stiffness(lam, mu, dim: int) -> np.ndarray:
    """(n_sig, n_sig) isotropic Voigt stiffness (engineering strains)."""
    n_sig = n_sig_for(dim)
    C = np.zeros((n_sig, n_sig))
    for i in range(dim):
        for j in range(dim):
            C[i, j] = lam + (2.0 * mu if i == j else 0.0)
    for k in range(dim, n_sig):
        C[k, k] = mu
    return C


def vti_stiffness(vp, vs, rho, epsilon=0.0, delta=0.0, gamma=0.0
                  ) -> np.ndarray:
    """VTI stiffness from Thomsen parameters (weak-anisotropy exact
    forms): C33 = rho vp^2, C44 = rho vs^2, C11 = C33 (1 + 2 epsilon),
    C66 = C44 (1 + 2 gamma), C13 from the exact delta relation.

    Inputs broadcast: scalars give (6, 6); per-element (E,) arrays give
    (E, 6, 6)."""
    vp, vs, rho, epsilon, delta, gamma = np.broadcast_arrays(
        *(np.asarray(a, dtype=np.float64)
          for a in (vp, vs, rho, epsilon, delta, gamma)))
    C33 = rho * vp * vp
    C44 = rho * vs * vs
    C11 = C33 * (1.0 + 2.0 * epsilon)
    C66 = C44 * (1.0 + 2.0 * gamma)
    C12 = C11 - 2.0 * C66
    C13 = np.sqrt(
        2.0 * delta * C33 * (C33 - C44) + (C33 - C44) ** 2) - C44
    C = np.zeros(C33.shape + (6, 6))
    C[..., 0, 0] = C[..., 1, 1] = C11
    C[..., 2, 2] = C33
    C[..., 0, 1] = C[..., 1, 0] = C12
    C[..., 0, 2] = C[..., 2, 0] = C13
    C[..., 1, 2] = C[..., 2, 1] = C13
    C[..., 3, 3] = C[..., 4, 4] = C44
    C[..., 5, 5] = C66
    return C


def rotate_stiffness(C: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Bond transformation: Voigt stiffness under rotation R (3x3).

    C' = M C M^T with the 6x6 Bond matrix of R — turns a VTI stiffness
    into tilted-TI/HTI media (e.g. R = rotation of the symmetry axis from
    z to x gives HTI).  Broadcasts over leading element axes of C.
    """
    R = np.asarray(R, dtype=np.float64)
    # Voigt pair order: (0,0), (1,1), (2,2), (1,2), (0,2), (0,1)
    p = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
    M = np.zeros((6, 6))
    for I, (i, j) in enumerate(p):
        for J, (k, l) in enumerate(p):
            if J < 3:
                M[I, J] = R[i, k] * R[j, k]
            else:
                M[I, J] = R[i, k] * R[j, l] + R[i, l] * R[j, k]
    return np.einsum("ab,...bc,dc->...ad", M, np.asarray(C), M)


def hti_stiffness(vp, vs, rho, epsilon=0.0, delta=0.0, gamma=0.0
                  ) -> np.ndarray:
    """TI medium with HORIZONTAL (x) symmetry axis: VTI rotated z->x
    (fracture-induced azimuthal anisotropy)."""
    Rzx = np.array([[0.0, 0.0, 1.0],
                    [0.0, 1.0, 0.0],
                    [-1.0, 0.0, 0.0]])
    return rotate_stiffness(
        vti_stiffness(vp, vs, rho, epsilon, delta, gamma), Rzx)


def christoffel_speeds(C: np.ndarray, rho: float, n) -> np.ndarray:
    """Phase speeds (ascending) for propagation direction n (3D Voigt C)."""
    n = np.asarray(n, dtype=np.float64)
    n = n / np.linalg.norm(n)
    V = np.array([[0, 5, 4], [5, 1, 3], [4, 3, 2]])
    G = np.zeros((3, 3))
    for i in range(3):
        for k in range(3):
            G[i, k] = sum(
                C[V[i, j], V[k, l]] * n[j] * n[l]
                for j in range(3) for l in range(3))
    return np.sqrt(np.maximum(np.linalg.eigvalsh(G), 0.0) / rho)


def max_wavespeed(C: np.ndarray, rho: float, samples: int = 50) -> float:
    """Max phase speed over sampled directions (CFL input)."""
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((samples, 3))
    dirs = np.concatenate([dirs, np.eye(3)])
    return float(max(christoffel_speeds(C, rho, d).max() for d in dirs))


def _voigt_strain_pair(dim: int):
    """Voigt slot -> list of (i, j) velocity/direction index pairs summed
    with unit weight (engineering shear)."""
    if dim == 2:
        return [[(0, 0)], [(1, 1)], [(0, 1), (1, 0)]]
    return [[(0, 0)], [(1, 1)], [(2, 2)],
            [(1, 2), (2, 1)], [(0, 2), (2, 0)], [(0, 1), (1, 0)]]


def make_aniso_stress_op(C: jax.Array):
    """Stress operator closure for per-element Voigt stiffness C
    (E, n_sig, n_sig); signature-compatible with ops.apply_stress_op."""

    def stress_op(p: ElasticParams, u, pool=None, traces=None):
        grad = _phys_grad(p, u)  # (E, dim, n_p, dim): [:, d, :, c]=du_c/dx_d
        pairs = _voigt_strain_pair(p.dim)
        eps = jnp.stack(
            [sum(grad[:, j, :, i] for (i, j) in slot) for slot in pairs],
            axis=-1)  # (E, n_p, n_sig) engineering strains of v
        vol = jnp.einsum("eij,epj->epi", C, eps)

        own, nbr = _traces(p, u, pool, traces)
        du = 0.5 * nbr + p.delta_u[:, :, None, None] * own
        nrm = p.normals[:, :, None, :]  # (E, nf, 1, dim)
        eps_f = jnp.stack(
            [sum(nrm[..., j] * du[..., i] for (i, j) in slot)
             for slot in pairs],
            axis=-1)  # (E, nf, nfp, n_sig)
        face = jnp.einsum("eij,efpj->efpi", C, eps_f)
        surf = _lift(p, face * p.Fscale[:, :, None, None])
        return vol + surf

    return stress_op
