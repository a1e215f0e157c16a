"""Elastic velocity-stress DG operators — the XLA einsum compute path.

Rebuild of the reference's hot kernels (SURVEY.md §5.2: per-stage cell /
interior-facet / exterior-facet parloops + mass solve).  Here each operator
application is one fused XLA computation over all elements:

  - volume term: batched reference-derivative matmuls contracted with
    per-element inverse-Jacobian factors (strong form — the per-element
    inverse mass of the reference's "explicit mode" is folded into the
    nodal differentiation matrices and LIFT, so no separate mass solve),
  - face term: one gather of neighbour traces via the precomputed
    face-owner index array, a pointwise numerical flux (central, Seigen
    parity; optional upwind penalty for extra damping), and a LIFT matmul.

Boundary conditions enter as per-(element,face) linear coefficients on the
own/neighbour traces (free surface = mirrored traction, absorbing =
half-vanishing ghost), so there is no control flow on the device.

State layout (SURVEY.md §9.1): elements are the batch axis.
  u     : (E, n_p, dim)      velocity
  sigma : (E, n_p, n_sig)    stress in Voigt order
Voigt order: 2D [xx, yy, xy]; 3D [xx, yy, zz, yz, xz, xy].
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.discrete import BC_ABSORB, BC_FREE, BC_RIGID, DiscreteMesh

# Voigt index of tensor entry (c, d)
VOIGT_2D = np.array([[0, 2], [2, 1]])
VOIGT_3D = np.array([[0, 5, 4], [5, 1, 3], [4, 3, 2]])


def voigt_map(dim: int) -> np.ndarray:
    return VOIGT_2D if dim == 2 else VOIGT_3D


def n_sig_for(dim: int) -> int:
    return 3 if dim == 2 else 6


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "Dr",
        "LIFT",
        "Ginv",
        "Fscale",
        "normals",
        "nbr",
        "inv_rho",
        "lam",
        "mu",
        "beta_t",
        "delta_u",
    ],
    meta_fields=["dim", "degree", "n_p", "n_faces", "n_fp", "n_sig", "fnodes"],
)
@dataclass(frozen=True)
class ElasticParams:
    """Device-resident operator data (pytree); meta fields are static."""

    # reference tables
    Dr: jax.Array  # (dim, n_p, n_p)
    LIFT: jax.Array  # (n_p, n_faces * n_fp)
    # geometry
    Ginv: jax.Array  # (E, dim, dim)
    Fscale: jax.Array  # (E, n_faces)
    normals: jax.Array  # (E, n_faces, dim)
    nbr: jax.Array  # (E, n_faces, n_fp) int32 into flat (E*n_p)
    # material (per element)
    inv_rho: jax.Array  # (E,)
    lam: jax.Array  # (E,)
    mu: jax.Array  # (E,)
    # flux coefficients (encode BCs; see build_params)
    beta_t: jax.Array  # (E, n_faces) own-trace coeff in traction jump
    delta_u: jax.Array  # (E, n_faces) own-trace coeff in velocity jump
    # static metadata
    dim: int
    degree: int
    n_p: int
    n_faces: int
    n_fp: int
    n_sig: int
    fnodes: tuple  # ((...face0 node ids...), ...) static for indexing


@dataclass(frozen=True)
class Material:
    """Per-element material; scalars broadcast. vp/vs/rho convention."""

    rho: np.ndarray | float
    vp: np.ndarray | float
    vs: np.ndarray | float

    @property
    def mu(self):
        return np.asarray(self.rho) * np.asarray(self.vs) ** 2

    @property
    def lam(self):
        return (
            np.asarray(self.rho) * np.asarray(self.vp) ** 2 - 2.0 * self.mu
        )

    @staticmethod
    def from_lame(rho, lam, mu) -> "Material":
        rho, lam, mu = map(np.asarray, (rho, lam, mu))
        return Material(
            rho=rho,
            vp=np.sqrt((lam + 2 * mu) / rho),
            vs=np.sqrt(mu / rho),
        )


def build_params(
    dm: DiscreteMesh,
    mat: Material,
    dtype=jnp.float32,
    flux: str = "central",
) -> ElasticParams:
    """Assemble device operator data from the discrete mesh + material.

    flux: "central" only (reference parity, SURVEY.md §4.2).  A dissipative
    upwind flux would couple u and sigma traces in both equations, which is
    incompatible with the staggered leapfrog scheme — the reference makes
    the same choice.
    """
    re = dm.re
    E = dm.num_elements
    dim = dm.dim

    rho = np.broadcast_to(np.asarray(mat.rho, dtype=np.float64), (E,))
    lam = np.broadcast_to(np.asarray(mat.lam, dtype=np.float64), (E,))
    mu = np.broadcast_to(np.asarray(mat.mu, dtype=np.float64), (E,))

    # Flux jump coefficients: jump = 0.5 * gathered_plus + beta * own.
    #   interior: 0.5 (s+ - s-)        -> beta_t = -0.5
    #   free:     -(n . s-)  (t+ := t-) -> beta_t = -1.5
    #   absorb:   -0.5 (n . s-)         -> beta_t = -1.0
    beta_t = np.full((E, re.n_faces), -0.5)
    beta_t[dm.bc == BC_FREE] = -1.5
    beta_t[dm.bc == BC_ABSORB] = -1.0
    #   rigid:    t unconstrained (t_hat = t-) -> jump 0 -> beta_t = -0.5
    #   interior: 0.5 (u+ - u-)         -> delta_u = -0.5
    #   free:     0            (u+ = u-) -> delta_u = -0.5
    #   absorb:   -0.5 u-                -> delta_u = -1.0
    delta_u = np.full((E, re.n_faces), -0.5)
    delta_u[dm.bc == BC_ABSORB] = -1.0
    #   rigid:    u_hat = 0 -> jump = -u-   -> delta_u = -1.5
    delta_u[dm.bc == BC_RIGID] = -1.5

    if flux != "central":
        raise ValueError(f"unknown flux {flux!r}")

    f32 = lambda a: jnp.asarray(a, dtype=dtype)
    return ElasticParams(
        Dr=f32(re.Dr),
        LIFT=f32(re.LIFT),
        Ginv=f32(dm.Ginv),
        Fscale=f32(dm.Fscale),
        normals=f32(dm.normals),
        nbr=jnp.asarray(dm.nbr, dtype=jnp.int32),
        inv_rho=f32(1.0 / rho),
        lam=f32(lam),
        mu=f32(mu),
        beta_t=f32(beta_t),
        delta_u=f32(delta_u),
        dim=dim,
        degree=re.degree,
        n_p=re.n_p,
        n_faces=re.n_faces,
        n_fp=re.n_fp,
        n_sig=n_sig_for(dim),
        fnodes=tuple(tuple(row) for row in re.fnodes.tolist()),
    )


def _phys_grad(p: ElasticParams, field: jax.Array) -> jax.Array:
    """(E, dim, n_p, C): physical derivatives d field / d x_d at the nodes."""
    der = jnp.einsum("rij,ejc->eric", p.Dr, field)
    return jnp.einsum("erd,eric->edic", p.Ginv, der)


def _traces(p: ElasticParams, field: jax.Array, pool: jax.Array | None,
            traces: jax.Array | None = None):
    """Own and neighbour face traces: each (E, n_faces, n_fp, C).

    ``pool`` overrides the gather source for neighbour traces: in sharded
    runs it is [local flat nodes | halo ghost pool] and ``p.nbr`` has been
    remapped into it by parallel.partition (single-chip: None -> gather from
    the field itself).  ``traces`` bypasses the gather entirely with
    precomputed neighbour traces (E, nf*nfp, C) — the structured roll
    exchange (ops/structured_exchange.py).
    """
    fn = jnp.asarray(np.array(p.fnodes), dtype=jnp.int32)
    own = field[:, fn]  # (E, n_faces, n_fp, C)
    if traces is not None:
        nbr = traces.reshape(own.shape)
        return own, nbr
    flat = pool if pool is not None else field.reshape((-1,) + field.shape[2:])
    nbr = flat[p.nbr]  # (E, n_faces, n_fp, C)
    return own, nbr


def _lift(p: ElasticParams, face_flux: jax.Array) -> jax.Array:
    """(E, n_faces, n_fp, C) scaled face flux -> (E, n_p, C) via LIFT."""
    E = face_flux.shape[0]
    flat = face_flux.reshape(E, p.n_faces * p.n_fp, -1)
    return jnp.einsum("im,emc->eic", p.LIFT, flat)


def traction_comps(n, s, dim: int) -> list:
    """Traction t_c = n_d sigma_{cd}, c < dim: ``n(d)`` a normal (or
    derivative-weight) component, ``s(k)`` the Voigt stress component k."""
    V = voigt_map(dim)
    return [sum(n(d) * s(V[c, d]) for d in range(dim)) for c in range(dim)]


def hooke_comps(lam, mu, gd, dim: int) -> list:
    """Voigt components of lam tr(G) I + mu (G + G^T), G[c, d] = gd(c, d)."""
    div = sum(gd(d, d) for d in range(dim))
    comps = [lam * div + 2.0 * mu * gd(c, c) for c in range(dim)]
    pairs = ((0, 1),) if dim == 2 else ((1, 2), (0, 2), (0, 1))
    return comps + [mu * (gd(a, b) + gd(b, a)) for a, b in pairs]


def apply_vel_op(
    p: ElasticParams,
    sigma: jax.Array,
    pool: jax.Array | None = None,
    traces: jax.Array | None = None,
) -> jax.Array:
    """A_u(sigma) = Minv * Lu(sigma): discrete (1/rho) div(sigma).

    Reference parity: the `uh1/uh2/utemp` solves of ElasticLF4
    (SURVEY.md §4.3) — RHS assembly (cell + facet kernels) and the
    block-diagonal mass solve, in one pass.
    """
    V = voigt_map(p.dim)
    grad = _phys_grad(p, sigma)  # (E, dim, n_p, n_sig)
    # div(sigma)_c = d_d sigma_{cd}
    div = jnp.stack(
        [
            sum(grad[:, d, :, V[c, d]] for d in range(p.dim))
            for c in range(p.dim)
        ],
        axis=-1,
    )  # (E, n_p, dim)

    own, nbr = _traces(p, sigma, pool, traces)
    nrm = p.normals[:, :, None, :]  # (E, n_faces, 1, dim)
    n = lambda d: nrm[..., d]
    t_own = jnp.stack(traction_comps(n, lambda k: own[..., k], p.dim), -1)
    t_nbr = jnp.stack(traction_comps(n, lambda k: nbr[..., k], p.dim), -1)
    jump_t = 0.5 * t_nbr + p.beta_t[:, :, None, None] * t_own
    flux = jump_t * p.Fscale[:, :, None, None]
    surf = _lift(p, flux)
    return p.inv_rho[:, None, None] * (div + surf)


def apply_stress_op(
    p: ElasticParams,
    u: jax.Array,
    pool: jax.Array | None = None,
    traces: jax.Array | None = None,
) -> jax.Array:
    """A_s(u) = Minv * Ls(u): discrete Hooke's law applied to sym grad(u).

    Reference parity: the `stemp/sh1/sh2` solves of ElasticLF4
    (SURVEY.md §4.3).
    """
    grad = _phys_grad(p, u)  # (E, dim, n_p, dim): grad[:, d, :, c] = du_c/dx_d
    vol = jnp.stack(hooke_comps(p.lam[:, None], p.mu[:, None],
                                lambda c, d: grad[:, d, :, c], p.dim), -1)

    own, nbr = _traces(p, u, pool, traces)
    du = 0.5 * nbr + p.delta_u[:, :, None, None] * own  # (E, nf, nfp, dim)
    nrm = p.normals[:, :, None, :]
    face = jnp.stack(hooke_comps(p.lam[:, None, None], p.mu[:, None, None],
                                 lambda c, d: nrm[..., d] * du[..., c],
                                 p.dim), -1)
    surf = _lift(p, face * p.Fscale[:, :, None, None])
    return vol + surf
