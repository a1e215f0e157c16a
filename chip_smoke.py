#!/usr/bin/env python
"""Smoke test of the whole system on one GPU, through the entry points a
user calls.  Exits non-zero, without the final ``ok`` line, unless every
phase passes; it never falls back to the CPU.

  python chip_smoke.py          # phases 1-4 on one card
  python chip_smoke.py --four   # phase 5 only: the DD path on four cards

Phases (f32, random-free: all data is the deterministic benchmark case):
  1. main path: the flagship 3D explosive source (E = 82944 P3 tets, LF4,
     sponge, point source, 16 receivers, 297 steps) through
     scripts/explosive_source.py with --impl auto and through
     ElasticSimulation, against the einsum oracle on the card
  2. the fused kernel's two operators against the oracle, P1-P4, 3D,
     E = 82944 (when ops/select.py picks the kernel)
  3. accuracy: the 3D eigenmode convergence order at P2/P3, N = 4, 8, on
     the auto engine (catches reduced-precision matmuls)
  4. every other auto destination once at small size: 2D, a scrambled
     unstructured mesh, upwind-RK4 + Q, C-PML, VTI, and one FWI
     value-and-gradient at E = 82944 P2
  5. (--four) the flagship on the general DD path over four cards against
     the one-card oracle run, with each card's peak memory

Every figure printed before the last line is a smoke figure (one short
run, compile included where said), not a benchmark.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = ["--dim", "3", "--n", "24", "--degree", "3", "--f0", "10",
            "--T", "0.25", "--receivers", "16"]

# Tolerances (relative L2 over all receiver samples, or max-abs relative
# for one operator application).  Engines differ only in f32 summation
# order: one application agrees to ~3e-7, a 300-step scan to ~1e-6.
TOL_SAME_ENGINE = 1e-5   # script vs facade, same engine
TOL_SEISMOGRAM = 1e-4    # an engine vs the einsum oracle, ~300 steps
TOL_OP = 1e-5            # one kernel application vs the oracle
ORDER_SLACK = 0.3        # tests/test_eigenmode.py: order >= q + 1 - 0.3


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_l2(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def _check(name, value, limit, ok):
    print(f"  {name}: {value:.3e} (limit {limit:.1e}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} {value} outside {limit}")


def _seis(tmp, tag, argv):
    """Run scripts/explosive_source.py in this process; its seismograms."""
    import numpy as np

    out = os.path.join(tmp, f"{tag}.npz")
    t0 = time.perf_counter()
    rc = _script("explosive_source").main(argv + ["--out", out])
    if rc:
        raise SystemExit(f"chip_smoke: explosive_source {tag} rc={rc}")
    seis = np.load(out)["seismograms"]
    if not (np.all(np.isfinite(seis)) and np.abs(seis).max() > 0):
        raise SystemExit(f"chip_smoke: {tag} seismograms not finite or zero")
    print(f"  [{tag}] wall (compile + run, smoke figure): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return seis


def phase_main_path(tmp, dev):
    import numpy as np

    from seigen_jax.mesh import box_mesh, build_discrete
    from seigen_jax.ops import Material
    from seigen_jax.solver import PointSource, line
    from seigen_jax.solver.simulation import ElasticSimulation, SimConfig

    print("phase 1: flagship explosive source, main path", flush=True)
    auto = _seis(tmp, "auto", FLAGSHIP + ["--impl", "auto"])
    oracle = _seis(tmp, "einsum", FLAGSHIP + ["--impl", "einsum"])
    _check("script auto vs einsum oracle, rel L2", _rel_l2(auto, oracle),
           TOL_SEISMOGRAM, _rel_l2(auto, oracle) <= TOL_SEISMOGRAM)

    topo = box_mesh(24, 24, 24)
    h = float(build_discrete(topo, 3).h.min())
    sim = ElasticSimulation(
        topo, Material(rho=1.0, vp=2.0, vs=1.0),
        SimConfig(degree=3, order=4, cfl=0.4, impl="auto",
                  free_sides=((2, "hi"),),
                  absorbing_sides=((0, "lo"), (0, "hi"), (1, "lo"),
                                   (1, "hi"), (2, "lo")),
                  sponge_width=0.15),
        sources=[PointSource(position=(0.5, 0.5, 0.8), f0=10.0,
                             radius=2 * h)],
        receiver_points=line((0.1, 0.5, 0.95), (0.9, 0.5, 0.95), 16))
    print(f"  chosen impl (ElasticSimulation): {sim._impl}", flush=True)
    t0 = time.perf_counter()
    _, seis = sim.run(0.25)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, seis = sim.run(0.25)
    t_run = time.perf_counter() - t0
    n = len(seis)
    print(f"  smoke figures: compile ~{t_first - t_run:.1f} s, "
          f"{n / t_run:.1f} steps/s over {n} steps, peak_bytes_in_use "
          f"{_peak_bytes(dev)}", flush=True)
    if not np.all(np.isfinite(seis)):
        raise SystemExit("chip_smoke: facade seismograms not finite")
    _check("ElasticSimulation vs script (same engine), rel L2",
           _rel_l2(seis, auto), TOL_SAME_ENGINE,
           _rel_l2(seis, auto) <= TOL_SAME_ENGINE)
    return sim._impl


def phase_kernel(dev):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.bench.throughput import setup_case
    from seigen_jax.ops import apply_stress_op, apply_vel_op
    from seigen_jax.ops.dg_kernel import DEGREES, make_kernel_ops

    print("phase 2: fused kernel vs einsum oracle, 3D, E = 82944",
          flush=True)
    vel_k, stress_k = make_kernel_ops()
    rng = np.random.default_rng(0)
    for q in DEGREES:
        _, p, *_ = setup_case(n=24, degree=q)
        E = p.Ginv.shape[0]
        sig = jnp.asarray(rng.standard_normal((E, p.n_p, 6)), jnp.float32)
        u = jnp.asarray(rng.standard_normal((E, p.n_p, 3)), jnp.float32)
        for name, k_op, ref_op, x in (("vel", vel_k, apply_vel_op, sig),
                                      ("stress", stress_k, apply_stress_op,
                                       u)):
            got = jax.jit(k_op)(p, x)
            ref = jax.jit(ref_op)(p, x)
            err = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
            _check(f"P{q} {name}_op max rel err", err, TOL_OP, err <= TOL_OP)
    print(f"  peak_bytes_in_use {_peak_bytes(dev)}", flush=True)


def phase_accuracy(tmp):
    print("phase 3: 3D eigenmode convergence on the auto engine, f32",
          flush=True)
    out = os.path.join(tmp, "eig3d.json")
    # N = 4, 8: at N = 2, 4 the P2 pair is pre-asymptotic (2.65 in f32)
    _script("eigenmode3d").main(["--degrees", "2,3", "--sizes", "4,8",
                                 "--impl", "auto", "--json", out])
    sweep = json.load(open(out))["sweep"]
    for q in (2, 3):
        order = sweep[f"P{q}"]["observed_order"]
        bar = q + 1 - ORDER_SLACK
        print(f"  P{q}: observed order {order:.2f} (bar >= {bar:.1f})",
              flush=True)
        if not order >= bar:
            raise SystemExit(f"chip_smoke: P{q} order {order} < {bar}")


def phase_other_destinations(tmp, dev):
    import jax
    import numpy as np

    from seigen_jax.bench.fwi_grad import run as fwi_grad_run
    from seigen_jax.bench.throughput import setup_case
    from seigen_jax.ops.select import make_ops, resolve_impl
    from seigen_jax.solver import run

    print("phase 4: other auto destinations, small sizes", flush=True)
    small2d = ["--dim", "2", "--n", "16", "--degree", "2", "--T", "0.1"]
    a = _seis(tmp, "2d_auto", small2d + ["--impl", "auto"])
    b = _seis(tmp, "2d_einsum", small2d + ["--impl", "einsum"])
    _check("2D auto vs einsum, rel L2", _rel_l2(a, b), TOL_SEISMOGRAM,
           _rel_l2(a, b) <= TOL_SEISMOGRAM)

    dm, p, src, damp, dt, st0 = setup_case(n=6, degree=2, scramble=True)
    impl = resolve_impl("auto", dev.platform, dm, p.Ginv.dtype)
    print(f"  scrambled unstructured mesh: auto -> {impl}", flush=True)
    finals = {}
    for name in (impl, "einsum"):
        vo, so = make_ops(name, p, dm)
        fin, _ = jax.jit(lambda p, st, vo=vo, so=so: run(
            p, st, dt, 50, order=4, src=src, damp=damp, vel_op=vo,
            stress_op=so))(p, st0)
        finals[name] = np.asarray(fin.u)
    err = _rel_l2(finals[impl], finals["einsum"])
    _check("scrambled auto vs einsum u, rel L2", err, TOL_SEISMOGRAM,
           err <= TOL_SEISMOGRAM and np.abs(finals[impl]).max() > 0)

    small3d = ["--dim", "3", "--n", "6", "--degree", "2", "--T", "0.1"]
    _seis(tmp, "upwind_rk4_q", small2d + ["--scheme", "upwind-rk4",
                                          "--qp", "50", "--qs", "30"])
    _seis(tmp, "cpml", small2d + ["--pml", "0.2"])
    _seis(tmp, "vti", small3d + ["--vti", "0.1,0.05,0.1"])

    print("  fwi value-and-grad, E = 82944 P2, einsum AD", flush=True)
    out = fwi_grad_run(n=24, degree=2, n_steps=20, repeats=1, shots=1,
                       segment=10, paths=("einsum",))
    row = out["einsum"]
    if not (np.isfinite(row["value"]) and row["value"] > 0):
        raise SystemExit("chip_smoke: fwi misfit not finite and positive")
    print(f"  fwi misfit {row['value']:.3e}, value+grad "
          f"{row['vg_seconds']:.2f} s (smoke figure), peak_bytes_in_use "
          f"{_peak_bytes(dev)}", flush=True)


def phase_four(tmp):
    import jax

    print("phase 5: flagship on the general DD path, four cards",
          flush=True)
    one = _seis(tmp, "one_card_einsum", FLAGSHIP + ["--impl", "einsum"])
    four = _seis(tmp, "shards4", FLAGSHIP + ["--shards", "4"])
    _check("4-card DD vs one-card einsum, rel L2", _rel_l2(four, one),
           TOL_SEISMOGRAM, _rel_l2(four, one) <= TOL_SEISMOGRAM)
    peaks = [_peak_bytes(d) for d in jax.devices()]
    print(f"  peak_bytes_in_use per card: {peaks}", flush=True)
    if not all(peaks):
        raise SystemExit("chip_smoke: a card did no work")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card DD phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    if args.four and len(devs) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from seigen_jax.bench.device import card_name_and_power
    from seigen_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(f"card (nvidia-smi name, power.limit): {card_name_and_power()}")
    print(f"device_kind: {dev.device_kind}; device count: {len(devs)}",
          flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            phase_four(tmp)
        else:
            impl = phase_main_path(tmp, dev)
            if impl == "triton":
                phase_kernel(dev)
            phase_accuracy(tmp)
            phase_other_destinations(tmp, dev)
    print(f"all phases passed in {time.perf_counter() - t0:.0f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
