"""Adjoint / FWI slice: differentiable misfits and material gradients.

The forward solver is a ``lax.scan`` of pure operator applications over a
registered-pytree ``ElasticParams`` whose material arrays (lam, mu,
inv_rho) are data leaves — so the whole simulation is reverse-mode
differentiable by construction.  This module adds what a full-waveform
inversion (FWI) loop needs on top:

- ``run_segmented``: the forward scan split into ``jax.checkpoint``-ed
  segments, trading recompute for O(segment + n_steps/segment) stored
  states instead of O(n_steps) — the standard adjoint checkpointing
  pattern, expressed as two nested scans instead of a tape.
- ``with_material``: re-assemble ElasticParams from (vp, vs, rho) element
  arrays with jnp ops (geometry untouched) so gradients flow to the
  geophysical parametrization.
- ``seismogram_misfit`` / ``make_fwi_gradient``: 0.5 * ||seis - obs||^2 at
  the receivers and its value-and-gradient wrt chosen material fields.

This goes beyond the reference (forward modelling only); it is the tool
a differentiable rebuild enables (ROADMAP #8).  Central-flux
LF2/LF4 path; gradient-checked against finite differences in
tests/test_adjoint.py.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.elastic import ElasticParams
from .receivers import ReceiverData, sample
from .source import SourceData
from .timestep import State, make_step


def run_segmented(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    segment: int | None = None,
    order: int = 4,
    src: SourceData | None = None,
    damp: jax.Array | None = None,
    receivers: ReceiverData | None = None,
    step0: int = 0,
    vel_op=None,
    stress_op=None,
):
    """Like solver.timestep.run, but with rematerialized segments.

    ``segment`` must divide n_steps; None runs one plain (fully stored)
    scan.  Returns (final State, seismograms or None).

    ``vel_op``/``stress_op`` override the general einsum operators, e.g.
    with ops.structured_exchange.make_structured_ops' roll closures —
    every formulation here is pure jnp, so gradients ride whichever is
    fastest for the mesh (FWI gradients do NOT need the Pallas kernels:
    the roll exchange is the fastest differentiable path on structured
    meshes, see solver/fwi.py).
    """
    kw = {}
    if vel_op is not None:
        kw["vel_op"] = vel_op
    if stress_op is not None:
        kw["stress_op"] = stress_op
    step = make_step(p, dt, order=order, src=src, damp=damp, **kw)
    dtype = p.Ginv.dtype
    dt_ = jnp.asarray(dt, dtype=dtype)

    def body(state, n):
        state = step(state, n.astype(dtype) * dt_)
        ys = sample(receivers, state.u) if receivers is not None else None
        return state, ys

    if not segment or segment >= n_steps:
        return jax.lax.scan(body, state0,
                            jnp.arange(step0, step0 + n_steps))
    if n_steps % segment:
        raise ValueError(f"segment {segment} must divide n_steps {n_steps}")

    @jax.checkpoint
    def chunk(state, n0):
        return jax.lax.scan(body, state, n0 + jnp.arange(segment))

    fin, ys = jax.lax.scan(
        chunk, state0,
        step0 + segment * jnp.arange(n_steps // segment))
    if ys is not None:
        ys = ys.reshape((n_steps,) + ys.shape[2:])
    return fin, ys


def with_material(p: ElasticParams, vp=None, vs=None, rho=None
                  ) -> ElasticParams:
    """Re-assemble params from per-element (vp, vs, rho) with jnp ops.

    Geometry/connectivity/flux coefficients are reused; only the material
    leaves change, so this is safe inside jit/grad and gradients flow to
    the geophysical parametrization (lam = rho (vp^2 - 2 vs^2),
    mu = rho vs^2).
    """
    dtype = p.Ginv.dtype
    if rho is None:
        rho = 1.0 / p.inv_rho
    rho = jnp.asarray(rho, dtype)
    if vs is None:
        vs = jnp.sqrt(p.mu * p.inv_rho)
    vs = jnp.asarray(vs, dtype)
    if vp is None:
        vp = jnp.sqrt((p.lam + 2 * p.mu) * p.inv_rho)
    vp = jnp.asarray(vp, dtype)
    mu = rho * vs * vs
    lam = rho * (vp * vp - 2 * vs * vs)
    return dataclasses.replace(p, lam=lam, mu=mu, inv_rho=1.0 / rho)


def seismogram_misfit(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed: jax.Array,
    order: int = 4,
    damp: jax.Array | None = None,
    segment: int | None = None,
) -> jax.Array:
    """0.5 * sum((seis - observed)^2) over (n_steps, R, dim)."""
    _, seis = run_segmented(
        p, state0, dt, n_steps, segment=segment, order=order, src=src,
        damp=damp, receivers=receivers)
    r = seis - observed
    return 0.5 * jnp.sum(r * r)


def make_fwi_gradient(
    p0: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed: jax.Array,
    fields: tuple = ("vp", "vs"),
    order: int = 4,
    damp: jax.Array | None = None,
    segment: int | None = None,
):
    """Jitted theta -> (misfit, grads) for theta = {field: (E,) array}.

    ``fields`` from {"vp", "vs", "rho"}; unlisted fields stay at p0's
    values.  Typical use: start from a smooth background model, descend.
    """

    @jax.jit
    def value_and_grad(theta: dict):
        def loss(theta):
            p = with_material(p0, **theta)
            return seismogram_misfit(
                p, state0, dt, n_steps, src, receivers, observed,
                order=order, damp=damp, segment=segment)

        return jax.value_and_grad(loss)(theta)

    def init_theta():
        full = {
            "vp": jnp.sqrt((p0.lam + 2 * p0.mu) * p0.inv_rho),
            "vs": jnp.sqrt(p0.mu * p0.inv_rho),
            "rho": 1.0 / p0.inv_rho,
        }
        return {k: full[k] for k in fields}

    return value_and_grad, init_theta


def make_visco_fwi_gradient(
    p: ElasticParams,
    w,
    state0: State,
    dt: float,
    n_steps: int,
    src: SourceData,
    receivers: ReceiverData,
    observed: jax.Array,
    f_band: tuple,
    L: int = 3,
    q0: float = 50.0,
    damp: jax.Array | None = None,
    segment: int | None = None,
):
    """Attenuation FWI: jitted theta -> (misfit, grads) for per-element
    Q^-1 fields, theta = {"qinv_kappa": (E,), "qinv_mu": (E,)}.

    Inverts INVERSE quality factors (the natural variable: the anelastic
    coefficients are linear in Q^-1, purely elastic is qinv=0, and a
    simple qinv >= 0 projection keeps the model physical — 1/Q has none
    of Q's sensitivity blow-up as Q -> inf).  The ViscoData anelastic
    coefficients are rebuilt differentiably inside the loss
    (y = qinv x y_unit, ops/viscoelastic.py build_visco:118-127) and the
    gradient rides plain reverse-mode AD through the upwind-RK4 memory-
    variable scan (solver/rk4.py run_rk4_visco), checkpointed in
    ``segment`` chunks because the carry includes the (E, n_p, n_sig, L)
    memory variables.

    The elastic material stays at ``p``'s values: upwind flux matrices
    (w) embed the elastic impedances, so elastic fields must be inverted
    on the central-flux path (make_fwi_gradient) —
    Q-after-velocity is the standard production sequence anyway.
    """
    from ..ops.viscoelastic import ViscoData, fit_anelastic_unit
    from .rk4 import run_rk4_visco

    dtype = p.Ginv.dtype
    w_l, y1 = fit_anelastic_unit(float(f_band[0]), float(f_band[1]), L)
    omegas = jnp.asarray(w_l, dtype)
    y_unit = jnp.asarray(y1, dtype)
    E = p.Ginv.shape[0]

    @jax.jit
    def _vg(theta: dict, src_, observed_):
        def loss(theta):
            v = ViscoData(
                omegas=omegas,
                y_kappa=jnp.outer(theta["qinv_kappa"], y_unit),
                y_mu=jnp.outer(theta["qinv_mu"], y_unit),
                L=L,
            )
            _, _, seis = run_rk4_visco(
                p, w, v, state0, dt, n_steps, src=src_, damp=damp,
                receivers=receivers, segment=segment)
            res = seis - observed_
            return 0.5 * jnp.sum(res * res)

        return jax.value_and_grad(loss)(theta)

    def value_and_grad(theta: dict, src_=None, observed_=None):
        """Optional per-call (src_, observed_) overrides: multi-shot
        loops reuse ONE compiled program instead of one per shot."""
        return _vg(theta, src if src_ is None else src_,
                   observed if observed_ is None else observed_)

    def init_theta():
        q = jnp.full((E,), 1.0 / q0, dtype)
        return {"qinv_kappa": q, "qinv_mu": q}

    return value_and_grad, init_theta
