"""Parameter-sweep benchmark harness — pybench parity (SURVEY.md §3
"Benchmark harness": sweeps over degree q in 1..4 and mesh size, per-region
timings, JSON result dumps).

Usage:
  python -m seigen_jax.bench.sweep --degrees 1,2,3 --sizes 8,16 --dim 3 \
      --steps 20 --out sweep.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def run_sweep(dim, degrees, sizes, n_steps, order, dtype_name, out_path=None,
              impl="auto", scramble=False):
    import jax
    import jax.numpy as jnp

    from ..ops.select import resolve_impl
    from ..utils.profiling import RegionTimer
    from .throughput import measure, setup_case

    dtype = jnp.dtype(dtype_name)
    platform = jax.devices()[0].platform
    rows = []
    for degree in degrees:
        for n in sizes:
            timer = RegionTimer()
            with timer.region("setup"):
                dm, p, src, damp, dt, state0 = setup_case(
                    n=n, degree=degree, dtype=dtype, dim=dim,
                    scramble=scramble,
                )
            impl_used = resolve_impl(impl, platform, dm, dtype)
            with timer.region("run"):
                res = measure(p, src, damp, dt, state0, n_steps=n_steps,
                              order=order, impl=impl_used, dm=dm)
            row = {
                "dim": dim,
                "degree": degree,
                "n": n,
                "elements": res.n_elements,
                "dof": res.n_dof,
                "steps": res.n_steps,
                "seconds": res.seconds,
                "steps_per_sec": res.steps_per_sec,
                "dof_updates_per_sec": res.dof_updates_per_sec,
                "timings": timer.report(),
                "backend": platform,
                "device_kind": jax.devices()[0].device_kind,
                "dtype": dtype_name,
                "impl": impl_used,
                "scramble": scramble,
            }
            rows.append(row)
            print(json.dumps(row))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3, choices=[2, 3])
    ap.add_argument("--degrees", type=str, default="1,2,3")
    ap.add_argument("--sizes", type=str, default="8,16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--impl", type=str, default="auto")
    ap.add_argument("--scramble", action="store_true",
                    help="permute cells + drop structure metadata (the "
                         "honest stand-in for a Gmsh unstructured import)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()

    run_sweep(
        args.dim,
        [int(d) for d in args.degrees.split(",")],
        [int(s) for s in args.sizes.split(",")],
        args.steps,
        args.order,
        args.dtype,
        args.out,
        impl=args.impl,
        scramble=args.scramble,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
