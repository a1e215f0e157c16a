"""Direction-split DG operators for convolutional PML (C-PML).

Unsplit C-PML (Komatitsch & Martin 2007 style, kappa=1) replaces each
spatial derivative with a memory-augmented one,

    d~/dx_d f  =  d/dx_d f + psi_d,
    d psi_d/dt = -(d_d + alpha_d) psi_d - d_d * (d/dx_d f),

so the wavefield decays inside graded-damping layers without the
interface reflection of a Cerjan sponge or the oblique-incidence
reflection of first-order characteristic BCs (both of which this
framework also ships — solver/damping.py).

The DG twist: the discrete derivative is volume-matmul PLUS lifted face
flux, so the direction split must carry the face term's n_d weighting
with it.  Both are split here EXACTLY:

  - ``apply_vel_op_split``:  direction-d contribution to div(sigma) with
    the traction-jump lift (n_d sigma_{cd} pieces), NOT multiplied by
    1/rho — summing over d and scaling by inv_rho reproduces
    ops.elastic.apply_vel_op bit-for-bit in f64 (tests/test_cpml.py).
  - ``apply_grad_op_split``: direction-d DG derivative of the velocity
    (volume + lifted n_d * velocity-jump) — the stress operator is
    ``hooke_pointwise`` of the summed split, exploiting that per-element
    (lam, mu) commute with LIFT (material constant within an element).

Both splits inherit every BC kind (free/absorb/rigid) unchanged because
the BC flux coefficients (beta_t, delta_u) are per-(element, face)
scalars that commute with the per-direction n_d weighting.

The reference stack had no PML at all (SURVEY.md §4.4: absorbing via
first-order BCs); this module is beyond-parity.  It lives on the einsum
(oracle) path, which runs only when C-PML is requested.
"""

from __future__ import annotations

import jax.numpy as jnp

from .elastic import ElasticParams, _lift, _phys_grad, _traces, voigt_map


def apply_vel_op_split(
    p: ElasticParams,
    sigma,
    pool=None,
    traces=None,
):
    """(E, dim, n_p, dim): direction-d contribution to the velocity RHS.

    out[:, d, :, c] = d sigma_{cd} / dx_d + LIFT(Fscale * n_d * jump_{cd})
    with sum_d out[:, d] * inv_rho == apply_vel_op (exact).
    """
    V = voigt_map(p.dim)
    grad = _phys_grad(p, sigma)  # (E, dim, n_p, n_sig)
    own, nbr = _traces(p, sigma, pool, traces)
    # componentwise jump with the BC coefficients (commutes with n_d)
    jmp = 0.5 * nbr + p.beta_t[:, :, None, None] * own  # (E, nf, nfp, n_sig)
    nrm = p.normals[:, :, None, :]
    fs = p.Fscale[:, :, None, None]
    out = []
    for d in range(p.dim):
        vol_d = jnp.stack(
            [grad[:, d, :, V[c, d]] for c in range(p.dim)], axis=-1
        )  # (E, n_p, dim)
        face_d = jnp.stack(
            [nrm[..., d] * jmp[..., V[c, d]] for c in range(p.dim)], axis=-1
        )
        out.append(vol_d + _lift(p, face_d * fs))
    return jnp.stack(out, axis=1)


def apply_grad_op_split(
    p: ElasticParams,
    u,
    pool=None,
    traces=None,
):
    """(E, dim, n_p, dim): direction-d DG derivative of the velocity.

    out[:, d, :, c] = d u_c / dx_d + LIFT(Fscale * n_d * du_c) with
    hooke_pointwise(out) == apply_stress_op (exact) — the d axis is the
    gradient matrix's row index, consumed by Hooke, never summed alone.
    """
    grad = _phys_grad(p, u)  # (E, dim, n_p, dim)
    own, nbr = _traces(p, u, pool, traces)
    du = 0.5 * nbr + p.delta_u[:, :, None, None] * own  # (E, nf, nfp, dim)
    nrm = p.normals[:, :, None, :]
    fs = p.Fscale[:, :, None, None]
    out = []
    for d in range(p.dim):
        out.append(grad[:, d] + _lift(p, du * nrm[..., d : d + 1] * fs))
    return jnp.stack(out, axis=1)


def hooke_pointwise(p: ElasticParams, gmat):
    """Isotropic Hooke applied to a gradient-like array.

    gmat: (E, dim, n_p, dim) with gmat[:, d, :, c] = (d u_c / dx_d)-like;
    returns (E, n_p, n_sig) Voigt stress rates.  Per-element (lam, mu)
    make this commute with LIFT, which is what lets the CPML stress
    update run Hooke once on the memory-augmented gradient matrix
    (the dim axis is the gradient row index, consumed here by the
    contraction — callers never sum it away themselves).
    """
    lam = p.lam[:, None]
    mu = p.mu[:, None]
    divu = sum(gmat[:, d, :, d] for d in range(p.dim))
    comps = [lam * divu + 2.0 * mu * gmat[:, c, :, c] for c in range(p.dim)]
    if p.dim == 2:
        comps.append(mu * (gmat[:, 1, :, 0] + gmat[:, 0, :, 1]))  # xy
    else:
        comps.append(mu * (gmat[:, 2, :, 1] + gmat[:, 1, :, 2]))  # yz
        comps.append(mu * (gmat[:, 2, :, 0] + gmat[:, 0, :, 2]))  # xz
        comps.append(mu * (gmat[:, 1, :, 0] + gmat[:, 0, :, 1]))  # xy
    return jnp.stack(comps, axis=-1)
