"""Throughput benchmark: DOF-updates/sec/chip on the 3D explosive source.

The north-star metric per BASELINE.json [D].  A "DOF update" is one field
coefficient advanced one full LF timestep; for the velocity-stress system the
per-step DOF count is E * n_p * (dim + n_sig).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import box_mesh, build_discrete
from ..ops import Material, build_params, n_sig_for
from ..ops.select import make_ops, resolve_impl
from ..solver import (
    PointSource,
    State,
    absorbing_bc_fn,
    build_sources,
    cfl_dt,
    run,
    sponge_mask,
)


BENCH_MAT = Material(rho=1.0, vp=2.0, vs=1.0)


@dataclass
class BenchResult:
    dof_updates_per_sec: float
    steps_per_sec: float
    n_elements: int
    n_dof: int
    degree: int
    n_steps: int
    seconds: float


def setup_case(
    n: int = 24,
    degree: int = 3,
    dtype=jnp.float32,
    dim: int = 3,
    scramble: bool = False,
):
    """3D explosive-source case: unit box, free top, absorbing elsewhere.

    ``scramble`` randomly permutes cell order and drops the structure
    metadata — the honest stand-in for a Gmsh unstructured import
    (benchmarks the unstructured path on identical geometry/physics).
    """
    extents = ((0.0, 1.0),) * dim
    if dim == 3:
        topo = box_mesh(n, n, n)
        free = [(2, "hi")]
        absorb = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        src_pos = (0.5, 0.5, 0.8)
    else:
        from ..mesh import rect_mesh

        topo = rect_mesh(n, n)
        free = [(1, "hi")]
        absorb = [(0, "lo"), (0, "hi"), (1, "lo")]
        src_pos = (0.5, 0.8)
    if scramble:
        import dataclasses

        rng = np.random.default_rng(0)
        topo = dataclasses.replace(
            topo, cells=topo.cells[rng.permutation(topo.num_cells)],
            structure=None)
    bc_fn = absorbing_bc_fn(extents, free_sides=free)
    dm = build_discrete(topo, degree, bc_fn=bc_fn)
    p = build_params(dm, BENCH_MAT, dtype=dtype)
    h_elem = float(dm.h.min())
    src = build_sources(
        dm,
        [PointSource(position=src_pos, f0=0.25 / h_elem, radius=2 * h_elem)],
        dtype=dtype,
    )
    damp = jnp.asarray(sponge_mask(dm, absorb, width=0.15), dtype=dtype)
    dt = cfl_dt(h_elem, 2.0, degree, cfl=0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    state0 = State(
        u=jnp.zeros((E, n_p, dim), dtype=dtype),
        s=jnp.zeros((E, n_p, n_sig_for(dim)), dtype=dtype),
    )
    return dm, p, src, damp, dt, state0


def measure(
    p, src, damp, dt, state0, n_steps: int = 100, order: int = 4,
    warmup: bool = True, impl: str = "einsum", dm=None,
) -> BenchResult:
    """Best-of-3 wall time of one jitted ``n_steps`` LF scan.

    impl: an operator engine of ops/select.py (einsum | xla_roll | triton;
    ``xla_roll`` needs the DiscreteMesh ``dm``).  Each rep ends in
    ``block_until_ready``, so the time covers the device work."""
    vel_op, stress_op = make_ops(impl, p, dm)

    @jax.jit
    def go(p, st):
        fin, _ = run(p, st, dt, n_steps, order=order, src=src, damp=damp,
                     vel_op=vel_op, stress_op=stress_op)
        return fin

    if warmup:
        go(p, state0).u.block_until_ready()
    dt_wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        go(p, state0).u.block_until_ready()
        dt_wall = min(dt_wall, time.perf_counter() - t0)

    E, n_p = state0.u.shape[:2]
    n_dof = E * n_p * (p.dim + n_sig_for(p.dim))
    return BenchResult(
        dof_updates_per_sec=n_dof * n_steps / dt_wall,
        steps_per_sec=n_steps / dt_wall,
        n_elements=E,
        n_dof=n_dof,
        degree=p.degree,
        n_steps=n_steps,
        seconds=dt_wall,
    )


def main(n: int = 24, degree: int = 3, n_steps: int = 100,
         impl: str = "auto") -> dict:
    """The benchmark cell: 3D explosive source, E = 6 n^3, LF4, sponge.

    ``auto`` runs the engine ops/select.py chooses for this device."""
    dm, p, src, damp, dt, state0 = setup_case(n=n, degree=degree)
    dev = jax.devices()[0]
    impl = resolve_impl(impl, dev.platform, dm, p.Ginv.dtype)
    res = measure(p, src, damp, dt, state0, n_steps=n_steps, impl=impl,
                  dm=dm)
    return {
        "metric": "dof_updates_per_sec_per_chip_3d_explosive",
        "value": res.dof_updates_per_sec,
        "unit": "DOF-updates/s/chip",
        "detail": {
            "elements": res.n_elements,
            "dof": res.n_dof,
            "degree": res.degree,
            "steps": res.n_steps,
            "seconds": res.seconds,
            "steps_per_sec": res.steps_per_sec,
            "backend": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "impl": impl,
        },
    }
