"""Operator-engine A/B on one device: the fused Triton kernel against the
XLA operators (roll exchange and face-owner gather) at the benchmark cell.

Two measurements, each taken in turns (every engine once per turn, the
order reversed on alternate turns) so that clock drift hits all alike:

  op    one vel_op and one stress_op application, mean of ``--calls``
        back-to-back calls ended by ``block_until_ready``
  scan  the 100-step LF4 scan of bench/throughput.py

Before timing, each engine's two operators are compared with the einsum
oracle.  Prints one JSON object per row; ``--out`` also writes them all.

  python -m seigen_jax.bench.kernel_ab --what op,scan --blocks 16,32 \
      --warps 2,4
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def engines(names, blocks, warps, p, dm):
    """name -> (vel_op, stress_op) for every engine under test; the
    kernel once per (block, warps) pair."""
    from ..ops.dg_kernel import make_kernel_ops
    from ..ops.select import make_ops

    out = {}
    for name in names:
        if name != "triton":
            out[name] = make_ops(name, p, dm)
            continue
        for b in blocks:
            for w in warps:
                out[f"triton_b{b}w{w}"] = make_kernel_ops(block=b,
                                                          num_warps=w)
    return out


def _turns(names, n_turns):
    for t in range(n_turns):
        yield from (names if t % 2 == 0 else names[::-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--engines", type=str, default="einsum,xla_roll,triton")
    ap.add_argument("--blocks", type=str, default="32")
    ap.add_argument("--warps", type=str, default="4")
    ap.add_argument("--what", type=str, default="op,scan")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..solver.timestep import run
    from ..utils.cache import enable_compile_cache
    from .device import card_name_and_power, require_gpu
    from .throughput import setup_case

    dev = require_gpu("kernel_ab")
    enable_compile_cache()
    card = card_name_and_power()
    print(f"card (nvidia-smi name, power.limit): {card}")
    dm, p, src, damp, dt, state0 = setup_case(n=args.n, degree=args.degree)
    E, n_p = dm.num_elements, dm.re.n_p
    ops = engines(args.engines.split(","),
                  [int(b) for b in args.blocks.split(",")],
                  [int(w) for w in args.warps.split(",")], p, dm)
    rng = np.random.default_rng(0)
    sigma = jnp.asarray(rng.standard_normal((E, n_p, p.n_sig)), jnp.float32)
    u = jnp.asarray(rng.standard_normal((E, n_p, p.dim)), jnp.float32)
    base = {"device_kind": dev.device_kind, "card": card, "E": E,
            "degree": args.degree}
    rows = []

    def emit(row):
        row = {**base, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    jitted = {name: (jax.jit(v), jax.jit(s)) for name, (v, s) in ops.items()}
    ref_v, ref_s = jitted["einsum"][0](p, sigma), jitted["einsum"][1](p, u)
    for name, (v, s) in jitted.items():
        t0 = time.perf_counter()
        ev = float(jnp.abs(v(p, sigma) - ref_v).max() / jnp.abs(ref_v).max())
        es = float(jnp.abs(s(p, u) - ref_s).max() / jnp.abs(ref_s).max())
        emit({"row": "check", "impl": name, "vel_rel_err": ev,
              "stress_rel_err": es,
              "compile_and_check_s": time.perf_counter() - t0})

    names = list(ops)
    if "op" in args.what:
        best = {}
        for name in _turns(names, args.turns):
            v, s = jitted[name]
            for op_name, f, x in (("vel", v, sigma), ("stress", s, u)):
                f(p, x).block_until_ready()
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    y = f(p, x)
                y.block_until_ready()
                ms = (time.perf_counter() - t0) / args.calls * 1e3
                key = (name, op_name)
                best.setdefault(key, []).append(ms)
        for (name, op_name), ms in best.items():
            emit({"row": "op", "impl": name, "op": op_name,
                  "ms_min": min(ms), "ms_median": float(np.median(ms)),
                  "ms_all": ms})

    if "scan" in args.what:
        scans = {}
        for name, (v, s) in ops.items():
            scans[name] = jax.jit(
                lambda p, st, v=v, s=s: run(
                    p, st, dt, args.steps, order=4, src=src, damp=damp,
                    vel_op=v, stress_op=s)[0])
            t0 = time.perf_counter()
            scans[name](p, state0).u.block_until_ready()
            emit({"row": "scan_compile", "impl": name,
                  "compile_and_first_s": time.perf_counter() - t0})
        times = {}
        finals = {}
        for name in _turns(names, args.turns):
            t0 = time.perf_counter()
            fin = scans[name](p, state0)
            fin.u.block_until_ready()
            times.setdefault(name, []).append(time.perf_counter() - t0)
            finals[name] = fin.u
        n_dof = E * n_p * (p.dim + p.n_sig)
        ref = finals["einsum"]
        for name, ts in times.items():
            emit({"row": "scan", "impl": name, "steps": args.steps,
                  "s_min": min(ts), "s_median": float(np.median(ts)),
                  "s_all": ts,
                  "dof_updates_per_sec": n_dof * args.steps / min(ts),
                  "u_rel_err_vs_einsum": float(
                      jnp.linalg.norm(finals[name] - ref)
                      / jnp.linalg.norm(ref))})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
