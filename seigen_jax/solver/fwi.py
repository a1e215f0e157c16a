"""Production full-waveform-inversion loop.

The round-2 demo (scripts/fwi.py) proved the gradient machinery; this
module is the production driver the reference never had (it is
forward-only — SURVEY.md §3 lists inversion as out of scope), built from
standard FWI practice re-expressed as jit-friendly JAX:

- **optax optimizers**: Adam (robust default) and L-BFGS with optax's
  zoom linesearch; plain max-normalized descent kept as the oracle.
- **Gradient smoothing / preconditioning**: a face-adjacency Jacobi
  smoother (element-graph Laplacian) applied to the raw gradient —
  suppresses the checkerboard/point-scatterer null-space modes that DG
  element-wise parametrizations produce.
- **Frequency continuation**: stages of low-pass-filtered misfits
  (Gaussian FIR along the time axis, applied identically to synthetic
  and observed data) from low to full band — the standard cure for
  cycle-skipping local minima.
- **Multi-shot batching**: shots ride `solver/shots.py` (vmap shot axis;
  `shard_shots` lays it over a device mesh for data parallelism).
- **Box bounds**: projected after every update (vp/vs/rho physical
  ranges).

Gradient path note: gradients are reverse-mode AD through the einsum
formulations (pure jnp, exact through the whole LF4 scan; the
structured-mesh roll exchange is the fast variant).  ``vg_factory``
accepts any other (value, grad) builder with the same contract.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.elastic import ElasticParams
from .adjoint import with_material
from .receivers import ReceiverData
from .shots import run_shots
from .source import SourceData
from .timestep import State


# --- frequency continuation: differentiable low-pass ----------------------
def lowpass_taps(dt: float, fmax: float, dtype=jnp.float32) -> jax.Array:
    """Gaussian FIR taps with -3 dB at ``fmax`` (normalized, odd length).

    A Gaussian has monotone frequency response (no ringing) and its time
    taps decay fast, so a short static kernel suffices; sigma chosen from
    |H(f)|^2 = 1/2 at fmax.
    """
    sigma_t = float(np.sqrt(np.log(2.0) / 2.0) / (np.pi * fmax))
    sigma_n = max(sigma_t / dt, 1e-3)
    half = max(int(np.ceil(4.0 * sigma_n)), 1)
    n = np.arange(-half, half + 1)
    taps = np.exp(-0.5 * (n / sigma_n) ** 2)
    return jnp.asarray(taps / taps.sum(), dtype)


def lowpass(x: jax.Array, taps: jax.Array, axis: int) -> jax.Array:
    """Apply FIR ``taps`` along ``axis`` (same-length output, zero pad)."""
    x = jnp.moveaxis(x, axis, -1)
    shp = x.shape
    half = taps.shape[0] // 2
    y = jax.lax.conv_general_dilated(
        x.reshape(-1, 1, shp[-1]).astype(taps.dtype),
        taps.reshape(1, 1, -1),
        window_strides=(1,),
        padding=((half, half),),
    )
    return jnp.moveaxis(y.reshape(shp), -1, axis)


# --- gradient smoothing ----------------------------------------------------
def make_smoother(p: ElasticParams, iters: int = 2, weight: float = 0.5):
    """Element-graph Jacobi smoother g -> smoothed g ((E,) arrays).

    Neighbours come from the face pairing (p.nbr decodes to the producer
    element per face; boundary faces self-pair, so boundary elements
    average over themselves — no special casing).  ``iters`` applications
    of g <- (1-w) g + w mean_f g[e2[:, f]].
    """
    nbr = np.asarray(p.nbr)
    e2 = jnp.asarray(nbr[:, :, 0] // p.n_p, jnp.int32)  # (E, nf)

    def smooth(g):
        for _ in range(iters):
            g = (1.0 - weight) * g + weight * jnp.mean(
                jnp.take(g, e2, axis=0), axis=1)
        return g

    return smooth


# --- the production loop ---------------------------------------------------
@dataclass
class FwiResult:
    theta: dict
    misfits: list = field(default_factory=list)
    bands: list = field(default_factory=list)
    wall_s: float = 0.0


def invert(
    p0: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData,
    observed: jax.Array,
    *,
    fields: tuple = ("vp",),
    optimizer: str = "adam",
    lr: float = 0.02,
    iters: int = 20,
    bands: tuple | None = None,
    smooth_iters: int = 2,
    smooth_weight: float = 0.5,
    bounds: dict | None = None,
    order: int = 4,
    damp: jax.Array | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
    batch: str = "vmap",
    theta0: dict | None = None,
    vg_factory=None,
    precond=None,
    log=None,
    checkpoint_path: str | None = None,
    resume: bool = False,
    checkpoint_every: int = 1,
) -> FwiResult:
    """Multi-stage FWI: for each band (low -> full), minimize the
    low-passed multi-shot L2 misfit over ``theta`` = {field: (E,)}.

    ``shots``: stacked SourceData (solver.shots.stack_shots), optionally
    shard_shots-placed for shot-axis data parallelism.  ``observed``:
    (S, n_steps, R, C) seismograms from the true model (same receiver
    set).  ``bands``: cutoff frequencies in Hz, e.g. (4.0, 8.0, None)
    — None = unfiltered full band.  ``bounds``: {field: (lo, hi)} box
    projection.  ``optimizer``: "adam" | "lbfgs" | "gd" (max-normalized
    descent, the round-2 demo's update).  ``iters`` per band.

    ``checkpoint_path`` + ``resume``: the inversion state (band, iter,
    theta, optax leaves, misfit history) is written atomically every
    ``checkpoint_every`` iterations and restored bitwise on resume, so a
    long inversion survives a lost process.  adam/gd only (L-BFGS
    carries linesearch closures in its state).

    ``precond``: optional per-element (E,) positive weights multiplied
    into every gradient field BEFORE smoothing (illumination /
    pseudo-Hessian compensation, e.g. 1/(I + eps) of an illumination
    map).  NOTE measured/derived scope: Adam is
    per-coordinate scale-invariant, so a static diagonal precond only
    reaches Adam through the smoother's neighbor mixing — it is the
    'gd' (max-normalized descent) path where this is the standard
    depth-compensation lever.

    Returns FwiResult with the final theta, per-iteration misfits, and
    wall-clock.
    """
    import optax

    if precond is not None:
        precond = jnp.asarray(precond, dtype=p0.Ginv.dtype)

    if bands is None:
        bands = (None,)
    dtype = p0.Ginv.dtype

    def full_theta():
        full = {
            "vp": jnp.sqrt((p0.lam + 2 * p0.mu) * p0.inv_rho),
            "vs": jnp.sqrt(p0.mu * p0.inv_rho),
            "rho": 1.0 / p0.inv_rho,
        }
        return {k: full[k] for k in fields}

    theta = dict(theta0) if theta0 is not None else full_theta()
    smoothp = (make_smoother(p0, smooth_iters, smooth_weight)
               if smooth_iters else None)

    def project(th):
        if not bounds:
            return th
        return {
            k: (jnp.clip(v, *bounds[k]) if k in bounds else v)
            for k, v in th.items()
        }

    def make_loss(taps):
        obs = observed if taps is None else lowpass(observed, taps, axis=1)

        def loss(th):
            p = with_material(p0, **th)
            _, seis = run_shots(
                p, state0, dt, n_steps, shots, receivers=receivers,
                order=order, damp=damp, segment=segment,
                vel_op=vel_op, stress_op=stress_op, batch=batch)
            if taps is not None:
                seis = lowpass(seis, taps, axis=1)
            r = seis - obs
            return 0.5 * jnp.sum(r * r)

        return loss

    def make_vg_host(taps):
        """batch='host' gradient: ONE jitted per-shot value_and_grad,
        accumulated over shots on host — S short device executions, each
        holding one shot's adjoint tape."""
        from .adjoint import run_segmented

        obs = observed if taps is None else lowpass(observed, taps, axis=1)

        def loss_one(th, shot, obs_s):
            p = with_material(p0, **th)
            _, seis = run_segmented(
                p, state0, dt, n_steps, segment=segment, order=order,
                src=shot, damp=damp, receivers=receivers,
                vel_op=vel_op, stress_op=stress_op)
            if taps is not None:
                seis = lowpass(seis, taps, axis=0)
            r = seis - obs_s
            return 0.5 * jnp.sum(r * r)

        vg_one = jax.jit(jax.value_and_grad(loss_one))
        obs_np = np.asarray(obs)  # pre-sliced on host: no per-shot device
        shots_np = jax.tree.map(np.asarray, shots)  # slice executions

        def vg(th):
            tot_v, tot_g = 0.0, None
            for i in range(shots.elems.shape[0]):
                shot_i = jax.tree.map(lambda x, i=i: x[i], shots_np)
                v, g = vg_one(th, shot_i, obs_np[i])
                g = jax.tree.map(np.asarray, g)  # accumulate on host
                tot_v += float(v)
                tot_g = (g if tot_g is None
                         else jax.tree.map(np.add, tot_g, g))
            return tot_v, tot_g

        return vg

    misfits: list = []
    band_log: list = []

    # --- inversion-state checkpointing (adam/gd) ----------------------
    import json as _json
    from pathlib import Path

    ck = None
    if checkpoint_path:
        if optimizer == "lbfgs":
            raise ValueError("checkpoint_path supports adam/gd only")
        ck = Path(checkpoint_path)
        if ck.suffix != ".npz":
            ck = ck.with_name(ck.name + ".npz")
    start_band, start_it = 0, 0
    resume_opt_leaves = None
    if ck is not None and resume and ck.exists():
        data = np.load(ck)
        start_band = int(data["band_idx"])
        start_it = int(data["it"]) + 1
        misfits = [float(v) for v in data["misfits"]]
        band_log = _json.loads(str(data["band_log"]))
        theta = {k: jnp.asarray(data[f"theta_{k}"])
                 for k in _json.loads(str(data["theta_keys"]))}
        resume_opt_leaves = [jnp.asarray(data[f"opt_{i}"])
                             for i in range(int(data["n_opt"]))]
        if start_it >= iters:  # saved at a band boundary: the band-end
            # log entry is appended AFTER the save, so restore it here
            band_log.append({"fc": bands[start_band],
                             "misfit_end": misfits[-1]})
            start_band, start_it, resume_opt_leaves = (
                start_band + 1, 0, None)
        if log:
            log(f"resumed from {ck}: band_idx={start_band} "
                f"it={start_it}")

    def save_ck(band_idx, it, opt_state):
        payload = {
            "band_idx": band_idx, "it": it,
            "misfits": np.asarray(misfits, np.float64),
            "band_log": _json.dumps(band_log),
            "theta_keys": _json.dumps(list(theta.keys())),
        }
        for k, v in theta.items():
            payload[f"theta_{k}"] = np.asarray(v)
        leaves = jax.tree_util.tree_leaves(opt_state)
        payload["n_opt"] = len(leaves)
        for i, lv in enumerate(leaves):
            payload[f"opt_{i}"] = np.asarray(lv)
        tmp = ck.with_name(ck.stem + ".tmp.npz")
        np.savez(tmp, **payload)  # atomic: write-then-rename
        tmp.replace(ck)

    t_start = time.perf_counter()
    for band_idx, fc in enumerate(bands):
        if band_idx < start_band:
            continue
        taps = (None if fc is None
                else lowpass_taps(dt, float(fc), dtype=dtype))
        loss = make_loss(taps)
        if vg_factory is not None:
            vg = vg_factory(taps)
        else:
            vg = (make_vg_host(taps) if batch == "host"
                  else jax.jit(jax.value_and_grad(loss)))

        if optimizer == "lbfgs":
            if batch == "host" or vg_factory is not None:
                raise ValueError("optimizer='lbfgs' needs a jittable "
                                 "batched loss (use batch='vmap'/'map', "
                                 "or optimizer='adam' with batch='host' "
                                 "or a vg_factory)")
            # optax L-BFGS carries value/grad in its state for the zoom
            # linesearch; gradient smoothing would make them inconsistent,
            # so L-BFGS runs on raw gradients (its inverse-Hessian builds
            # its own preconditioner).
            opt = optax.lbfgs()
            opt_state = opt.init(theta)
            value_and_grad = optax.value_and_grad_from_state(loss)
            for it in range(iters):
                value, grad = value_and_grad(theta, state=opt_state)
                updates, opt_state = opt.update(
                    grad, opt_state, theta, value=value, grad=grad,
                    value_fn=loss)
                theta = project(optax.apply_updates(theta, updates))
                misfits.append(float(value))
                if log:
                    log(f"band={fc} iter={it} misfit={float(value):.4e}")
        else:
            opt = (optax.adam(lr) if optimizer == "adam"
                   else optax.sgd(1.0))
            opt_state = opt.init(theta)
            it_first = 0
            if band_idx == start_band and resume_opt_leaves is not None:
                opt_state = jax.tree_util.tree_unflatten(
                    jax.tree_util.tree_structure(opt_state),
                    resume_opt_leaves)
                it_first = start_it

            @jax.jit
            def apply_update(grad, opt_state, theta):
                # precond + smoothing + (gd normalization) + optax +
                # projection in ONE device execution
                if precond is not None:
                    grad = {k: v * precond for k, v in grad.items()}
                if smoothp is not None:
                    grad = {k: smoothp(v) for k, v in grad.items()}
                if optimizer == "gd":
                    # max-normalized descent: lr in model units at the
                    # most sensitive element (the round-2 demo update)
                    gmax = jnp.max(jnp.asarray(
                        [jnp.abs(v).max() for v in grad.values()]))
                    grad = {k: (lr / jnp.maximum(gmax, 1e-30)) * v
                            for k, v in grad.items()}
                updates, opt_state = opt.update(grad, opt_state, theta)
                return project(optax.apply_updates(theta, updates)), \
                    opt_state

            for it in range(it_first, iters):
                value, grad = vg(theta)
                theta, opt_state = apply_update(grad, opt_state, theta)
                misfits.append(float(value))
                if log:
                    log(f"band={fc} iter={it} misfit={float(value):.4e}")
                if ck is not None and (it + 1 == iters
                                       or (it + 1) % checkpoint_every
                                       == 0):
                    save_ck(band_idx, it, opt_state)
        band_log.append({"fc": fc, "misfit_end": misfits[-1]})

    return FwiResult(theta=theta, misfits=misfits, bands=band_log,
                     wall_s=time.perf_counter() - t_start)
