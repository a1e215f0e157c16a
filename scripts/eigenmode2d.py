#!/usr/bin/env python
"""2D eigenmode convergence study — CLI parity with the reference's
tests/eigenmode/eigenmode2d.py problem script (SURVEY.md §2 layer 1).

Runs an analytic plane-wave eigenmode on a periodic unit square for an
h-refinement series at the given degree, reports L2 errors and the observed
convergence order, and exits nonzero if the order is below the acceptance
threshold.

Example:
  python scripts/eigenmode2d.py --degree 2 --sizes 4,8,16 --order 4 --f64
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--degree", type=int, default=2, choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--sizes", type=str, default="4,8,16",
                    help="comma-separated mesh sizes N (NxN quads x2 tris)")
    ap.add_argument("--order", type=int, default=4, choices=[2, 4],
                    help="leapfrog temporal order (LF2/LF4)")
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--periods", type=float, default=1.0,
                    help="simulation length in eigenmode periods")
    ap.add_argument("--mode", choices=["S", "P"], default="S")
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'upwind-rk4' restores q+1 orders at odd degrees")
    ap.add_argument("--f64", action="store_true",
                    help="float64 (strict orders; CPU)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--json", type=str, default=None,
                    help="write results JSON here")
    ap.add_argument("--min-order", type=float, default=None,
                    help="fail if observed order is below this")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.mesh import build_discrete, rect_mesh
    from seigen_jax.ops import Material, build_params
    from seigen_jax.solver import (
        PlaneWave, State, cfl_dt, convergence_order, interpolate, l2_error,
        run,
    )

    dtype = jnp.float64 if args.f64 else jnp.float32
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]),
                   mode=args.mode)
    T = args.periods * pw.period

    sizes = [int(s) for s in args.sizes.split(",")]
    results = []
    for N in sizes:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), args.degree)
        p = build_params(dm, mat, dtype=dtype)
        dt = cfl_dt(dm.h.min(), float(np.asarray(mat.vp)), args.degree,
                    args.cfl)
        n_steps = int(np.ceil(T / dt))
        dt = T / n_steps
        if args.scheme == "upwind-rk4":
            from seigen_jax.ops.upwind import build_upwind_data
            from seigen_jax.solver.rk4 import run_rk4

            wdata = build_upwind_data(dm, mat, dtype=dtype)
            st = State(
                u=jnp.asarray(interpolate(dm, pw.u, 0.0), dtype=dtype),
                s=jnp.asarray(interpolate(dm, pw.sigma, 0.0), dtype=dtype),
            )
            fin, _ = jax.jit(
                lambda p, w, st: run_rk4(p, w, st, dt, n_steps)
            )(p, wdata, st)
        else:
            st = State(
                u=jnp.asarray(interpolate(dm, pw.u, 0.0), dtype=dtype),
                s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt),
                              dtype=dtype),
            )
            fin, _ = jax.jit(
                lambda p, st: run(p, st, dt, n_steps, order=args.order)
            )(p, st)
        err = l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt)
        results.append({"N": N, "h": 1.0 / N, "steps": n_steps,
                        "l2_error_u": err})
        print(f"N={N:4d}  steps={n_steps:5d}  L2(u) = {err:.6e}")

    order = None
    if len(sizes) >= 2:
        order = convergence_order(
            [r["h"] for r in results], [r["l2_error_u"] for r in results]
        )
        print(f"observed spatial order: {order:.2f} (degree {args.degree})")

    payload = {"config": vars(args), "results": results,
               "observed_order": order}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
    if args.min_order is not None and order is not None:
        if order < args.min_order:
            print(f"FAIL: order {order:.2f} < {args.min_order}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
