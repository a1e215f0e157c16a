"""Ensemble-of-shots batching: vmap the forward solve over sources.

The reference has no data-parallel axis (SURVEY.md §3.2: DP listed as a
"possible extension"); the natural one is batching independent
SHOTS (seismic experiments sharing mesh/material) with ``jax.vmap`` — one
compiled program, the shot axis rides the hardware like a batch dimension,
and multi-shot FWI misfits become a single vmapped reduction.  Memory
scales linearly with shots (fields are (S, E, n_p, C)); combine with
``run_segmented``'s checkpointing for gradient runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.elastic import ElasticParams
from .adjoint import run_segmented
from .receivers import ReceiverData
from .source import SourceData
from .timestep import State


def pad_shot(s: SourceData, K: int) -> SourceData:
    """Pad a shot's source entries to K with zero-amplitude entries
    (element 0, zero vectors — injecting exactly nothing)."""
    k = s.elems.shape[0]
    if k == K:
        return s
    pad = K - k

    def pz(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    return SourceData(
        elems=pz(s.elems), vec_u=pz(s.vec_u), vec_s=pz(s.vec_s),
        # padded wavelets get f0=1 (ricker divides by f0), amp=0
        f0=jnp.concatenate([s.f0, jnp.ones((pad,), s.f0.dtype)]),
        t0=pz(s.t0), amp=pz(s.amp))


def stack_shots(shots: list[SourceData]) -> SourceData:
    """Stack per-shot SourceData into one with a leading shot axis.

    Shots with different source-entry counts (e.g. Gaussian blobs covering
    different element counts per position) are zero-amplitude-padded to
    the largest count."""
    K = max(s.elems.shape[0] for s in shots)
    shots = [pad_shot(s, K) for s in shots]
    stack = lambda f: jnp.stack([getattr(s, f) for s in shots])  # noqa:E731
    return SourceData(
        elems=stack("elems"), vec_u=stack("vec_u"), vec_s=stack("vec_s"),
        f0=stack("f0"), t0=stack("t0"), amp=stack("amp"),
    )


def shard_shots(shots: SourceData, mesh) -> SourceData:
    """Lay the stacked shot axis out over a device mesh axis ("shot").

    Data parallelism for ensemble/FWI workloads: each chip owns S/P whole
    shots (mesh/material replicated), so the vmapped solve in ``run_shots``
    runs embarrassingly parallel with zero per-step communication (SURVEY
    §3.2 DP row).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        spec = P("shot", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, shots)


def run_shots(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData | None = None,
    order: int = 4,
    damp: jax.Array | None = None,
    segment: int | None = None,
    vel_op=None,
    stress_op=None,
    batch: str = "vmap",
):
    """Batched forward solve over the leading shot axis of ``shots``.

    Returns (final States (S, ...), seismograms (S, n_steps, R, dim)).
    ``state0`` is shared (unbatched) across shots.  If ``shots`` was laid
    out with ``shard_shots``, XLA partitions the whole solve over the
    mesh's "shot" axis (per-shot programs are independent; outputs come
    back shot-sharded).

    ``batch``: "vmap" fuses all shots into one batched program (fastest
    when it fits); "map" compiles ONE shot body and lax.map's over the
    shot axis — same results, ~S x smaller XLA program and peak memory;
    "host" jits the per-shot program ONCE and loops shots on host — S
    short device executions instead of one long one (do NOT wrap the call
    in jax.jit in this mode).
    """

    def one(shot_src):
        return run_segmented(
            p, state0, dt, n_steps, segment=segment, order=order,
            src=shot_src, damp=damp, receivers=receivers,
            vel_op=vel_op, stress_op=stress_op)

    if batch == "host":
        one_j = jax.jit(one)
        outs = [
            one_j(jax.tree.map(lambda x, i=i: x[i], shots))
            for i in range(shots.elems.shape[0])
        ]
        final = jax.tree.map(lambda *xs: jnp.stack(xs),
                             *[o[0] for o in outs])
        seis = (jnp.stack([o[1] for o in outs])
                if outs[0][1] is not None else None)
        return final, seis
    if batch == "map":
        return jax.lax.map(one, shots)
    return jax.vmap(one)(shots)


def shots_misfit(
    p: ElasticParams,
    state0: State,
    dt: float,
    n_steps: int,
    shots: SourceData,
    receivers: ReceiverData,
    observed: jax.Array,
    order: int = 4,
    damp: jax.Array | None = None,
    segment: int | None = None,
) -> jax.Array:
    """0.5 * sum over shots of ||seis_s - observed_s||^2 (vmapped)."""
    _, seis = run_shots(
        p, state0, dt, n_steps, shots, receivers=receivers, order=order,
        damp=damp, segment=segment)
    r = seis - observed
    return 0.5 * jnp.sum(r * r)
