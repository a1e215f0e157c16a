#!/usr/bin/env python
"""Matmul-precision accuracy study: the gate for running the operators'
f32 contractions below full precision.

Runs a long 2D P3 plane-wave eigenmode on the XLA operators under each
``jax.default_matmul_precision`` scheme, in one process, and records the
final L2 error against the analytic solution.  A faster scheme (TF32,
bf16x3) may become the default only if its error matches 'highest' at the
spatial-error floor.

  python scripts/precision_study.py [N] [degree] [--out study.json]
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

SCHEMES = ("highest", "BF16_BF16_F32_X3", "tensorfloat32", "bfloat16")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("N", type=int, nargs="?", default=16)
    ap.add_argument("degree", type=int, nargs="?", default=3)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.mesh import build_discrete, rect_mesh
    from seigen_jax.ops import Material, build_params
    from seigen_jax.ops.select import XLA_STRUCTURED, make_ops
    from seigen_jax.solver import (PlaneWave, State, cfl_dt, interpolate,
                                   l2_error, run)
    from seigen_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    mat = Material(rho=1.0, vp=2.0, vs=1.0)
    dm = build_discrete(rect_mesh(args.N, args.N, periodic=(0, 1)),
                        args.degree)
    p = build_params(dm, mat, dtype=jnp.float32)
    vel_op, stress_op = make_ops(XLA_STRUCTURED, p, dm)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    T = 2.0 * pw.period
    dt = cfl_dt(dm.h.min(), 2.0, args.degree, 0.4)
    n_steps = int(np.ceil(T / dt))
    dt = T / n_steps
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0), jnp.float32),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt), jnp.float32),
    )
    out = {"N": args.N, "degree": args.degree, "steps": n_steps,
           "device_kind": jax.devices()[0].device_kind, "schemes": {}}
    for scheme in SCHEMES:
        # the precision is read while tracing: a fresh jit per scheme
        with jax.default_matmul_precision(scheme):
            fin, _ = jax.jit(lambda p, st: run(
                p, st, dt, n_steps, order=4, vel_op=vel_op,
                stress_op=stress_op))(p, st)
        err = l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt)
        out["schemes"][scheme] = {"err": float(err)}
        print(scheme, out["schemes"][scheme], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
