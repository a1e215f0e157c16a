"""Upwind (Godunov) flux coupled elastic operator + impedance data.

The reference's central flux (ops/elastic.py) is non-dissipative — required
by the staggered leapfrog scheme — but admits spurious high-wavenumber modes
with super-physical group velocities (measured as precursor waves from point
sources).  This module provides the classical
alternative: the exact-Riemann (Godunov) interface flux for isotropic
elasticity, which upwinds along characteristics and damps those modes, paired
with an RK4 integrator (solver/rk4.py) since the dissipative flux couples u
and sigma traces in both equations (incompatible with staggered leapfrog).

Riemann states at a face with outward normal n, own/neighbour traces
(u-, t- = sigma- . n) / (u+, t+) and P/S impedances Zp = rho vp, Zs = rho vs:

  t*_N = [Zp+ t-_N + Zp- t+_N + Zp- Zp+ (u+_N - u-_N)] / (Zp- + Zp+)
  t*_T = [Zs+ t-_T + Zs- t+_T + Zs- Zs+ (u+_T - u-_T)] / (Zs- + Zs+)
  u*_N = [Zp- u-_N + Zp+ u+_N + (t+_N - t-_N)] / (Zp- + Zp+)
  u*_T = [Zs- u-_T + Zs+ u+_T + (t+_T - t-_T)] / (Zs- + Zs+)

(N/T = normal/tangential projections.)  Strong-form corrections are
LIFT(n.(t* - t-))/rho for the velocity equation and C:(sym(n x (u* - u-)))
for the stress equation.  Boundary ghosts: free surface (t+ = -t-, u+ = u-)
gives t* = 0; rigid (u+ = -u-, t+ = t-) gives u* = 0; absorbing uses the
zero exterior state — the exact first-order characteristic absorber.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.discrete import BC_ABSORB, BC_FREE, BC_RIGID, DiscreteMesh
from .elastic import ElasticParams, Material, _lift, _phys_grad, voigt_map


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["zp_own", "zs_own", "zp_nbr", "zs_nbr", "ghost_u",
                 "ghost_t"],
    meta_fields=[],
)
@dataclass(frozen=True)
class UpwindData:
    """Per-face impedances + boundary ghost coefficients."""

    zp_own: jax.Array  # (E, 1, 1) P impedance of the element
    zs_own: jax.Array  # (E, 1, 1)
    zp_nbr: jax.Array  # (E, nf, 1) neighbour P impedance at each face
    zs_nbr: jax.Array  # (E, nf, 1)
    # ghost state: u+ = gu * u_gathered, t+ = gt * t_gathered (interior: 1)
    ghost_u: jax.Array  # (E, nf, 1)
    ghost_t: jax.Array  # (E, nf, 1)


def build_upwind_data(dm: DiscreteMesh, mat: Material,
                      dtype=jnp.float32) -> UpwindData:
    E = dm.num_elements
    nf = dm.re.n_faces
    rho = np.broadcast_to(np.asarray(mat.rho, np.float64), (E,))
    vp = np.broadcast_to(np.asarray(mat.vp, np.float64), (E,))
    vs = np.broadcast_to(np.asarray(mat.vs, np.float64), (E,))
    zp = rho * vp
    zs = rho * vs

    nbr_e = dm.nbr[:, :, 0] // dm.re.n_p  # (E, nf) neighbour element ids
    zp_nbr = zp[nbr_e]
    zs_nbr = zs[nbr_e]

    gu = np.ones((E, nf))
    gt = np.ones((E, nf))
    gu[dm.bc == BC_RIGID] = -1.0
    gt[dm.bc == BC_FREE] = -1.0
    gu[dm.bc == BC_ABSORB] = 0.0
    gt[dm.bc == BC_ABSORB] = 0.0
    # boundary faces gather own traces, so neighbour impedance = own there
    # (already true since nbr_e == own element id on boundaries)

    f32 = lambda a, shape: jnp.asarray(np.reshape(a, shape), dtype)
    return UpwindData(
        zp_own=f32(zp, (E, 1, 1)),
        zs_own=f32(zs, (E, 1, 1)),
        zp_nbr=f32(zp_nbr, (E, nf, 1)),
        zs_nbr=f32(zs_nbr, (E, nf, 1)),
        ghost_u=f32(gu, (E, nf, 1)),
        ghost_t=f32(gt, (E, nf, 1)),
    )


def _face_values(p: ElasticParams, field, traces):
    """(own, nbr) face traces (E, nf, nfp, C) from field + gathered traces."""
    fn = jnp.asarray(np.array(p.fnodes), dtype=jnp.int32)
    own = field[:, fn]
    nbr = traces.reshape(own.shape[0], p.n_faces, p.n_fp, -1)
    return own, nbr


def _traction(p, nrm, sig_face):
    """(E, nf, nfp, dim) traction n . sigma from Voigt face traces."""
    V = voigt_map(p.dim)
    return jnp.stack(
        [
            sum(nrm[..., d] * sig_face[..., V[c, d]] for d in range(p.dim))
            for c in range(p.dim)
        ],
        axis=-1,
    )


def apply_coupled_upwind(
    p: ElasticParams,
    w: UpwindData,
    u: jax.Array,
    s: jax.Array,
    u_traces: jax.Array,
    s_traces: jax.Array,
):
    """(du, ds) with Godunov fluxes; traces pre-gathered (E, nf*nfp, C)."""
    V = voigt_map(p.dim)
    dim = p.dim

    # --- volume terms (same strong form as the central path) ---
    grad_s = _phys_grad(p, s)
    div = jnp.stack(
        [sum(grad_s[:, d, :, V[c, d]] for d in range(dim))
         for c in range(dim)],
        axis=-1,
    )
    grad_u = _phys_grad(p, u)
    lam = p.lam[:, None]
    mu = p.mu[:, None]
    divu = sum(grad_u[:, d, :, d] for d in range(dim))
    vol_s = []
    for c in range(dim):
        vol_s.append(lam * divu + 2.0 * mu * grad_u[:, c, :, c])
    if dim == 2:
        vol_s.append(mu * (grad_u[:, 1, :, 0] + grad_u[:, 0, :, 1]))
    else:
        vol_s.append(mu * (grad_u[:, 2, :, 1] + grad_u[:, 1, :, 2]))
        vol_s.append(mu * (grad_u[:, 2, :, 0] + grad_u[:, 0, :, 2]))
        vol_s.append(mu * (grad_u[:, 1, :, 0] + grad_u[:, 0, :, 1]))
    vol_s = jnp.stack(vol_s, axis=-1)

    # --- Riemann fluxes at face nodes ---
    u_own, u_nbr = _face_values(p, u, u_traces)
    s_own, s_nbr = _face_values(p, s, s_traces)
    nrm = p.normals[:, :, None, :]  # (E, nf, 1, dim)
    t_own = _traction(p, nrm, s_own)
    t_nbr = _traction(p, nrm, s_nbr)

    # boundary ghosts (interior: coefficients are 1 -> plain neighbour)
    gu = w.ghost_u[:, :, :, None]
    gt = w.ghost_t[:, :, :, None]
    u_plus = gu * u_nbr
    t_plus = gt * t_nbr

    def split(vec):
        vn = sum(nrm[..., d] * vec[..., d] for d in range(dim))[..., None]
        return vn * nrm, vec - vn * nrm

    uN_m, uT_m = split(u_own)
    uN_p, uT_p = split(u_plus)
    tN_m, tT_m = split(t_own)
    tN_p, tT_p = split(t_plus)

    zp_m = w.zp_own[:, :, :, None]
    zs_m = w.zs_own[:, :, :, None]
    zp_p = w.zp_nbr[:, :, :, None]
    zs_p = w.zs_nbr[:, :, :, None]

    # acoustic media (vs = 0): no shear characteristics exist — the
    # tangential Riemann contribution degenerates; guard the 0/0.
    zs_sum = zs_m + zs_p
    zs_safe = jnp.where(zs_sum > 0, zs_sum, 1.0)
    has_shear = zs_sum > 0

    t_star = (
        (zp_p * tN_m + zp_m * tN_p + zp_m * zp_p * (uN_p - uN_m))
        / (zp_m + zp_p)
        + jnp.where(
            has_shear,
            (zs_p * tT_m + zs_m * tT_p + zs_m * zs_p * (uT_p - uT_m))
            / zs_safe,
            0.5 * (tT_m + tT_p),
        )
    )
    u_star = (
        (zp_m * uN_m + zp_p * uN_p + (tN_p - tN_m)) / (zp_m + zp_p)
        + jnp.where(
            has_shear,
            (zs_m * uT_m + zs_p * uT_p + (tT_p - tT_m)) / zs_safe,
            0.5 * (uT_m + uT_p),
        )
    )

    dt_flux = (t_star - t_own) * p.Fscale[:, :, None, None]
    du_flux = u_star - u_own

    surf_u = _lift(p, dt_flux)
    du = p.inv_rho[:, None, None] * (div + surf_u)

    lamf = p.lam[:, None, None]
    muf = p.mu[:, None, None]
    ndu = sum(nrm[..., d] * du_flux[..., d] for d in range(dim))
    comps = []
    for c in range(dim):
        comps.append(lamf * ndu + 2.0 * muf * nrm[..., c] * du_flux[..., c])
    if dim == 2:
        comps.append(
            muf * (nrm[..., 0] * du_flux[..., 1]
                   + nrm[..., 1] * du_flux[..., 0]))
    else:
        comps.append(
            muf * (nrm[..., 1] * du_flux[..., 2]
                   + nrm[..., 2] * du_flux[..., 1]))
        comps.append(
            muf * (nrm[..., 0] * du_flux[..., 2]
                   + nrm[..., 2] * du_flux[..., 0]))
        comps.append(
            muf * (nrm[..., 0] * du_flux[..., 1]
                   + nrm[..., 1] * du_flux[..., 0]))
    face_s = jnp.stack(comps, axis=-1) * p.Fscale[:, :, None, None]
    ds = vol_s + _lift(p, face_s)
    return du, ds
