#!/usr/bin/env python
"""3D eigenmode convergence sweep — CLI parity with the reference's
tests/eigenmode/eigenmode3d.py; [D] config 3 (P1-P4, h-refinement,
order-of-accuracy check).

Example:
  python scripts/eigenmode3d.py --degrees 1,2,3,4 --sizes 2,4 --f64 --cpu
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--degrees", type=str, default="1,2,3,4")
    ap.add_argument("--sizes", type=str, default="2,4",
                    help="N per axis (6*N^3 tets)")
    ap.add_argument("--order", type=int, default=4, choices=[2, 4])
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'lf': central flux + leapfrog (reference parity); "
                         "'upwind-rk4': Godunov flux + RK4 (restores clean "
                         "q+1 orders at odd degrees)")
    ap.add_argument("--impl", choices=["auto", "einsum", "xla_roll", "triton"],
                    default="auto",
                    help="operator engine of the LF scheme (ops/select.py)")
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--periods", type=float, default=0.5)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.mesh import box_mesh, build_discrete
    from seigen_jax.ops import Material, build_params
    from seigen_jax.ops.select import make_ops, resolve_impl
    from seigen_jax.solver import (
        PlaneWave, State, cfl_dt, convergence_order, interpolate, l2_error,
        run,
    )

    dtype = jnp.float64 if args.f64 else jnp.float32
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    pw = PlaneWave(
        mat=mat,
        k=2 * np.pi * np.array([1.0, 1.0, 0.0]),
        mode="S",
        polarization=np.array([0.0, 0.0, 1.0]),
    )
    T = args.periods * pw.period

    sweep = {}
    for degree in [int(d) for d in args.degrees.split(",")]:
        rows = []
        for N in [int(s) for s in args.sizes.split(",")]:
            dm = build_discrete(box_mesh(N, N, N, periodic=(0, 1, 2)), degree)
            p = build_params(dm, mat, dtype=dtype)
            dt = cfl_dt(dm.h.min(), float(np.asarray(mat.vp)), degree,
                        args.cfl)
            n_steps = int(np.ceil(T / dt))
            dt = T / n_steps
            if args.scheme == "upwind-rk4":
                from seigen_jax.ops.upwind import build_upwind_data
                from seigen_jax.solver.rk4 import run_rk4

                wdata = build_upwind_data(dm, mat, dtype=dtype)
                # co-located ICs at t=0 (no staggering with RK4)
                st = State(
                    u=jnp.asarray(interpolate(dm, pw.u, 0.0), dtype=dtype),
                    s=jnp.asarray(interpolate(dm, pw.sigma, 0.0),
                                  dtype=dtype),
                )
                fin, _ = jax.jit(
                    lambda p, w, st: run_rk4(p, w, st, dt, n_steps)
                )(p, wdata, st)
            else:
                impl = resolve_impl(args.impl, jax.devices()[0].platform,
                                    dm, dtype)
                vo, so = make_ops(impl, p, dm)
                st = State(
                    u=jnp.asarray(interpolate(dm, pw.u, 0.0), dtype=dtype),
                    s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt),
                                  dtype=dtype),
                )
                fin, _ = jax.jit(
                    lambda p, st: run(p, st, dt, n_steps, order=args.order,
                                      vel_op=vo, stress_op=so)
                )(p, st)
            err = l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt)
            rows.append({"N": N, "h": 1.0 / N, "steps": n_steps,
                         "l2_error_u": err})
            print(f"P{degree} N={N:3d} steps={n_steps:5d} L2(u)={err:.6e}"
                  + ("" if args.scheme != "lf" else f" impl={impl}"))
        order = (
            convergence_order([r["h"] for r in rows],
                              [r["l2_error_u"] for r in rows])
            if len(rows) >= 2 else None
        )
        if order is not None:
            print(f"P{degree}: observed order {order:.2f}")
        sweep[f"P{degree}"] = {"rows": rows, "observed_order": order}

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "sweep": sweep}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
