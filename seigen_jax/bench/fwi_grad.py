"""Time the FWI gradient: reverse-mode AD through the LF4 scan on the XLA
operators, with the roll exchange (``xla_roll``) and the face-owner
gather (``einsum``).

Builds the salt-demo acquisition (3D layered model, surface shots/receivers,
sponge + free surface) at a configurable size, then times value_and_grad
evaluations of each path and cross-checks their f32 vp gradients.  Each
timed evaluation is jitted per shot and ends in ``block_until_ready``; the
first call (compile) is not timed; best-of-N wall times.

Usage:
  python -m seigen_jax.bench.fwi_grad [n] [degree] [steps] [repeats]
"""

from __future__ import annotations

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def run(n=24, degree=1, n_steps=200, repeats=2, shots=2, segment=20,
        seed=0, paths=("xla_roll", "einsum"), out_path=None):
    from ..mesh import box_mesh, build_discrete
    from ..ops import Material, build_params  # noqa: F401 (CLI symmetry)
    from ..ops.select import make_ops
    from ..solver import (PointSource, State, absorbing_bc_fn,
                          build_receivers, build_sources, cfl_dt, line,
                          sponge_mask)
    from ..solver.adjoint import run_segmented, with_material
    from ..solver.models import Layer, layered_model

    dtype = jnp.float32
    extents = ((0.0, 1.0),) * 3
    dm = build_discrete(
        box_mesh(n, n, n), degree,
        bc_fn=absorbing_bc_fn(extents, free_sides=[(2, "hi")]))
    mat0 = layered_model(dm, [
        Layer(bottom=-0.01, top=0.5, rho=1.2, vp=2.4, vs=1.2),
        Layer(bottom=0.5, top=1.01, rho=1.0, vp=2.0, vs=1.0)])
    p0 = build_params(dm, mat0, dtype=dtype)
    E = dm.num_elements
    h = float(dm.h.min())
    dt = cfl_dt(h, 2.4, degree, 0.4)
    if segment:
        if n_steps < segment:
            raise ValueError(f"n_steps {n_steps} < segment {segment}")
        n_steps -= n_steps % segment
    f0 = 0.15 * 2.4 / h / (degree + 1)
    src_list = [
        build_sources(dm, [PointSource(position=(float(x), 0.5, 0.85),
                                       f0=f0, radius=2 * h)], dtype=dtype)
        for x in np.linspace(0.25, 0.75, shots)]
    rcv = build_receivers(
        dm, line((0.1, 0.5, 0.9), (0.9, 0.5, 0.9), 16), dtype=dtype)
    damp = jnp.asarray(sponge_mask(
        dm, [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")],
        width=0.15), dtype)
    vp0 = np.asarray(jnp.sqrt((p0.lam + 2 * p0.mu) * p0.inv_rho))
    theta = {"vp": jnp.asarray(vp0, dtype)}
    rng = np.random.default_rng(seed)
    obs = jnp.asarray(
        0.01 * rng.standard_normal((shots, n_steps, 16, 3)), dtype)

    st0 = State(u=jnp.zeros((E, dm.re.n_p, 3), dtype),
                s=jnp.zeros((E, dm.re.n_p, 6), dtype))

    out = {"E": E, "degree": degree, "n_steps": n_steps, "shots": shots,
           "segment": segment, "backend": jax.devices()[0].platform}
    grads = {}
    for path in paths:
        @jax.jit
        def vg_one(th, src_k, obs_k, path=path):
            def loss(th):
                p = with_material(p0, **th)
                vo, so = make_ops(path, p, dm)
                _, seis = run_segmented(
                    p, st0, dt, n_steps, segment=segment, order=4,
                    src=src_k, damp=damp, receivers=rcv, vel_op=vo,
                    stress_op=so)
                r = seis - obs_k
                return 0.5 * jnp.sum(r * r)
            return jax.value_and_grad(loss)(th)

        def vg(th):
            tot_v, tot_g = 0.0, None
            for k in range(shots):
                v, g = vg_one(th, src_list[k], obs[k])
                tot_v += float(v)
                tot_g = g if tot_g is None else jax.tree.map(
                    jnp.add, tot_g, g)
            return tot_v, tot_g

        v, g = vg(theta)  # compile + correctness sample
        jax.block_until_ready(g["vp"])
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            v, g = vg(theta)
            jax.block_until_ready(g["vp"])
            best = min(best, time.perf_counter() - t0)
        grads[path] = np.asarray(g["vp"], np.float64)
        out[path] = {
            "vg_seconds": best,
            "value": float(v),
            # fwd sweep + adjoint sweep + checkpoint recompute ~ 3 sweeps
            "grad_dof_per_s": E * dm.re.n_p * 9 * n_steps * shots
            * 3.0 / best,
        }
        print(json.dumps({path: out[path]}), flush=True)
    if len(grads) == 2:
        a, b = grads.values()
        out["grad_cosine"] = float(
            np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
        out["grad_rel_maxdiff"] = float(
            np.abs(a - b).max() / (np.abs(a).max() + 1e-30))
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=24)
    ap.add_argument("degree", type=int, nargs="?", default=1)
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("repeats", type=int, nargs="?", default=2)
    ap.add_argument("--shots", type=int, default=2)
    ap.add_argument("--segment", type=int, default=20)
    ap.add_argument("--paths", type=str, default="xla_roll,einsum")
    ap.add_argument("--out", type=str, default=None,
                    help="write the result JSON here (artifact gating)")
    args = ap.parse_args()
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()
    run(n=args.n, degree=args.degree, n_steps=args.steps,
        repeats=args.repeats, shots=args.shots, segment=args.segment,
        paths=tuple(args.paths.split(",")), out_path=args.out)
