"""Explicit staggered leapfrog time stepping (LF2 / LF4) as one jitted scan.

Rebuild of ElasticLF4's 8-solve timestep (SURVEY.md §4.3).  The whole step —
6 operator applications (LF4), source injection, sponge damping, receiver
sampling — is a single function scanned over steps with ``lax.scan``; XLA
fuses across the stage boundaries (the role the SLOPE C++ tiling library
plays in the reference, SURVEY.md §3.1 item 2).

Staggering: u lives at integer steps t = n dt, sigma at half steps
t = (n + 1/2) dt.  Each update evaluates the counterpart field at its
midpoint; the O(dt^3) modified-equation correction makes LF4 4th order:

  uh1   = Au(s)                    # s at t+dt/2
  stemp = As(uh1); uh2 = Au(stemp)
  u'    = u + dt*uh1 + dt^3/24 * uh2
  sh1   = As(u') [+ stress source at t+dt]
  utemp = Au(sh1); sh2 = As(utemp)
  s'    = s + dt*sh1 + dt^3/24 * sh2
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..ops.elastic import ElasticParams, apply_stress_op, apply_vel_op
from .receivers import ReceiverData, sample
from .source import SourceData, inject_stress, inject_velocity


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["u", "s"],
    meta_fields=[],
)
@dataclass(frozen=True)
class State:
    u: jax.Array  # (E, n_p, dim) velocity at t = n dt
    s: jax.Array  # (E, n_p, n_sig) stress at t = (n + 1/2) dt


def compose_lf_step(vel, stress, inject_u, inject_s, post, dt, order: int):
    """THE LF2/LF4 physics, in exactly one place.

    Every runner (one device, domain-decomposed) builds its own (vel,
    stress, inject_u, inject_s, post) closures over its own data layout and
    composes the step here, so a physics change — a new source kind, a new
    correction term — happens once and propagates to all execution paths.

      vel(s) / stress(u): the discrete operators Mu^-1 Lu / Ms^-1 Ls
      inject_u(du, t) / inject_s(ds, t): add source terms to a stage RHS
      post(u, s) -> (u, s): after-update hook (sponge damping)
      dt: jnp scalar of the run dtype; t passed to step is the START time
          of the step (u at t, sigma at t + dt/2).
    """
    if order not in (2, 4):
        raise ValueError("order must be 2 or 4 (reference parity: LF2/LF4)")
    c3 = dt**3 / 24.0

    def step(u, s, t):
        # --- velocity update: t -> t + dt, using sigma at t + dt/2 ---
        uh1 = inject_u(vel(s), t + 0.5 * dt)
        if order == 4:
            u = u + dt * uh1 + c3 * vel(stress(uh1))
        else:
            u = u + dt * uh1
        # --- stress update: t + dt/2 -> t + 3 dt/2, using u at t + dt ---
        sh1 = inject_s(stress(u), t + dt)
        if order == 4:
            s = s + dt * sh1 + c3 * stress(vel(sh1))
        else:
            s = s + dt * sh1
        return post(u, s)

    return step


def damp_post(damp: jax.Array | None):
    """Standard-layout (E, n_p, C) sponge-damping post hook."""
    if damp is None:
        return lambda u, s: (u, s)
    return lambda u, s: (u * damp[:, :, None], s * damp[:, :, None])


def make_step(
    p: ElasticParams,
    dt: float,
    order: int = 4,
    src: SourceData | None = None,
    damp: jax.Array | None = None,
    vel_op=apply_vel_op,
    stress_op=apply_stress_op,
):
    """Build the single-timestep function (State, t) -> State."""
    dt = jnp.asarray(dt, dtype=p.Ginv.dtype)
    lf = compose_lf_step(
        vel=lambda s: vel_op(p, s),
        stress=lambda u: stress_op(p, u),
        inject_u=lambda du, t: inject_velocity(src, du, t),
        inject_s=lambda ds, t: inject_stress(src, ds, t),
        post=damp_post(damp),
        dt=dt,
        order=order,
    )

    def step(state: State, t) -> State:
        u, s = lf(state.u, state.s, t)
        return State(u=u, s=s)

    return step


def staggered_init(
    p: ElasticParams,
    u0: jax.Array,
    s0: jax.Array,
    dt: float,
    order: int = 4,
    vel_op=apply_vel_op,
    stress_op=apply_stress_op,
) -> State:
    """Build a staggered State from co-located (u, sigma) at t = 0.

    The leapfrog scheme stores sigma at t = dt/2; advancing it there with a
    discrete Taylor series (s' = As u, s'' = As Au s, s''' = As Au As u keeps
    the initialization error at the scheme's own order and — because it uses
    the discrete operators — makes runs with different dt share exactly the
    same t=0 data (pure-temporal-error comparisons, general non-analytic ICs).
    """
    dt = jnp.asarray(dt, dtype=p.Ginv.dtype)
    h = 0.5 * dt
    s1 = stress_op(p, u0)
    s = s0 + h * s1
    if order == 4:
        s2 = stress_op(p, vel_op(p, s0))
        s3 = stress_op(p, vel_op(p, stress_op(p, u0)))
        s = s + (h**2 / 2.0) * s2 + (h**3 / 6.0) * s3
    return State(u=u0, s=s)


def run(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    order: int = 4,
    src: SourceData | None = None,
    damp: jax.Array | None = None,
    receivers: ReceiverData | None = None,
    record_pressure: bool = False,
    vel_op=apply_vel_op,
    stress_op=apply_stress_op,
    step0: int = 0,
):
    """Run n_steps; returns (final State, seismograms or None).

    Seismograms: (n_steps, R, dim [+1]) velocity samples (plus pressure
    -tr(sigma)/dim if requested), sampled after each full step.
    ``step0``: global index of the first step (resume support — keeps
    time-dependent sources in phase).
    """
    step = make_step(
        p, dt, order=order, src=src, damp=damp, vel_op=vel_op,
        stress_op=stress_op,
    )
    dt_ = jnp.asarray(dt, dtype=p.Ginv.dtype)

    def body(state, n):
        t = n.astype(p.Ginv.dtype) * dt_
        state = step(state, t)
        ys = None
        if receivers is not None:
            rec_u = sample(receivers, state.u)
            if record_pressure:
                pr = -jnp.mean(state.s[..., : p.dim], axis=-1, keepdims=True)
                rec_p = sample(receivers, pr)
                ys = jnp.concatenate([rec_u, rec_p], axis=-1)
            else:
                ys = rec_u
        return state, ys

    final, seis = jax.lax.scan(body, state0, jnp.arange(n_steps) + step0)
    return final, seis


@functools.partial(jax.jit, static_argnames=("n_steps", "order",
                                             "record_pressure"))
def run_jit(p, state0, dt, n_steps, order=4, src=None, damp=None,
            receivers=None, record_pressure=False):
    return run(
        p, state0, dt, n_steps, order=order, src=src, damp=damp,
        receivers=receivers, record_pressure=record_pressure,
    )


def cfl_dt(h_min: float, vp_max: float, degree: int, cfl: float = 0.5) -> float:
    """Stability-bound timestep dt = cfl * h_min / (vp_max * (2q + 1)).

    The reference's exact constant is unrecoverable (SURVEY.md §9.3); the
    bound was derived empirically by bisection (results/cfl_study.json):
    in this normalization LF2 is stable to cfl ~0.75-0.85 and LF4 to
    ~2.0-2.6 across P1-P4 in 2D/3D.  The default cfl=0.4 used by the tests
    and CLIs keeps a ~2x (LF2) / ~5x (LF4) margin; production LF4 runs can
    safely use cfl ~1.0-1.5 for fewer steps.
    """
    return cfl * h_min / (vp_max * (2 * degree + 1))
