"""Viscoelastic attenuation: generalized-Maxwell (memory-variable) Q.

Beyond-reference capability (ROADMAP #6; the reference models purely
elastic media).  Standard rheology for time-domain seismic codes
(Emmerich & Korn 1987; Moczo & Kristek 2005): the anelastic stress is
carried by L relaxation mechanisms with memory variables xi_l obeying

    d xi_l / dt = omega_l (Y_l * (C eps_dot) - xi_l)
    d sigma / dt = C eps_dot - sum_l xi_l

where C eps_dot is the unrelaxed elastic stress rate (the existing stress
operator) and the anelastic coefficients Y_l are least-squares fit so that
the model's Q(omega) ~ target Q over a frequency band.  Q is parametrized
per element by (Q_kappa, Q_mu) acting on the isotropic / deviatoric parts
of the stress rate.

Device mapping: memory variables extend the scan carry by an
(E, n_p, n_sig, L) array — pure elementwise updates that XLA fuses into
the RK4 stage arithmetic; no extra exchanges (xi has no spatial coupling).
Time integration pairs with the RK4/upwind path (co-located state); the
ODEs are non-stiff as long as omega_max dt <~ 1 (relaxation frequencies
live inside the resolved band, so the CFL-limited dt already resolves
them).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .elastic import ElasticParams


def fit_anelastic_unit(f_min: float, f_max: float, L: int = 3):
    """Fit unit-Q^-1 anelastic coefficients over [f_min, f_max].

    The generalized Maxwell body gives (low-loss approximation)

        Q^-1(w) ~ sum_l Y_l * (w w_l) / (w^2 + w_l^2)

    linear in Y, so we fit once for Q^-1 = 1 and scale Y by the actual
    Q^-1 per element.  Returns (omegas (L,), y_unit (L,)): relaxation
    angular frequencies (log-spaced across the band) and unit
    coefficients.
    """
    if L < 1:
        raise ValueError("need at least one mechanism")
    w_l = 2 * np.pi * np.logspace(np.log10(f_min), np.log10(f_max), L)
    wk = 2 * np.pi * np.logspace(
        np.log10(f_min), np.log10(f_max), max(2 * L - 1, L))
    A = (wk[:, None] * w_l[None, :]) / (wk[:, None] ** 2 + w_l[None, :] ** 2)
    y, *_ = np.linalg.lstsq(A, np.ones(len(wk)), rcond=None)
    return w_l, y


def model_q_inv(omegas, y, freqs):
    """Q^-1(f) of the fitted model (for tests/diagnostics)."""
    w = 2 * np.pi * np.asarray(freqs)[:, None]
    return (y[None, :] * (w * omegas[None, :])
            / (w**2 + omegas[None, :] ** 2)).sum(axis=1)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["omegas", "y_kappa", "y_mu"],
    meta_fields=["L"],
)
@dataclass(frozen=True)
class ViscoData:
    """Per-element anelastic data: omegas (L,), y_* (E, L)."""

    omegas: jax.Array
    y_kappa: jax.Array
    y_mu: jax.Array
    L: int


def build_visco(
    p: ElasticParams,
    q_kappa,
    q_mu,
    f_min: float,
    f_max: float,
    L: int = 3,
) -> ViscoData:
    """Anelastic data for per-element (Q_kappa, Q_mu) over [f_min, f_max].

    Pass np.inf entries for purely elastic elements (Y -> 0).
    """
    E = p.Ginv.shape[0]
    dtype = p.Ginv.dtype
    w_l, y1 = fit_anelastic_unit(f_min, f_max, L)
    qk = np.broadcast_to(np.asarray(q_kappa, dtype=np.float64), (E,))
    qm = np.broadcast_to(np.asarray(q_mu, dtype=np.float64), (E,))
    return ViscoData(
        omegas=jnp.asarray(w_l, dtype),
        y_kappa=jnp.asarray(np.outer(1.0 / qk, y1), dtype),
        y_mu=jnp.asarray(np.outer(1.0 / qm, y1), dtype),
        L=L,
    )


def split_iso_dev(ds: jax.Array, dim: int):
    """Voigt (E, n_p, n_sig) stress rate -> isotropic + deviatoric parts."""
    iso_scalar = ds[..., :dim].mean(axis=-1)  # (E, n_p)
    iso = jnp.concatenate(
        [jnp.repeat(iso_scalar[..., None], dim, axis=-1),
         jnp.zeros_like(ds[..., dim:])], axis=-1)
    return iso, ds - iso


def anelastic_rates(v: ViscoData, ds_el: jax.Array, xi: jax.Array,
                    dim: int):
    """(d xi, sum_l xi_l) given the unrelaxed elastic stress rate.

    xi: (E, n_p, n_sig, L).  d xi_l = omega_l (Y_l ds_parts - xi_l).
    """
    iso, dev = split_iso_dev(ds_el, dim)
    target = (iso[..., None] * v.y_kappa[:, None, None, :]
              + dev[..., None] * v.y_mu[:, None, None, :])
    dxi = v.omegas * (target - xi)
    return dxi, xi.sum(axis=-1)
