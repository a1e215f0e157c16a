#!/usr/bin/env python
"""Explosive-source production run — CLI parity with the reference's
tests/explosive_source/explosive_source_lf4.py ([D] configs 2 and 4).

2D or 3D domain, Ricker explosive point source, free surface on top,
absorbing (characteristic + Cerjan sponge) elsewhere, receiver line,
optional layered/salt heterogeneous model, VTK snapshots, seismogram npz,
checkpoint/resume, multi-chip sharded execution.

Examples:
  python scripts/explosive_source.py --dim 2 --n 64 --degree 3 --T 1.0
  python scripts/explosive_source.py --dim 3 --n 20 --layered --vtk out/run.pvd
  python scripts/explosive_source.py --dim 3 --n 16 --shards 8 --cpu
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--n", type=int, default=32, help="elements per unit axis")
    ap.add_argument("--degree", type=int, default=2, choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--order", type=int, default=4, choices=[2, 4])
    ap.add_argument("--T", type=float, default=1.0)
    ap.add_argument("--cfl", type=float, default=0.4)
    ap.add_argument("--f0", type=float, default=None,
                    help="Ricker peak frequency (default: resolution-scaled)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="Gmsh .msh file (overrides --dim/--n; source/"
                         "receivers placed extent-relative)")
    ap.add_argument("--bc-free", type=str, default=None,
                    help="comma-separated Gmsh physical group names mapped "
                         "to free-surface BCs")
    ap.add_argument("--bc-absorb", type=str, default=None,
                    help="comma-separated Gmsh physical group names mapped "
                         "to absorbing BCs")
    ap.add_argument("--layered", action="store_true",
                    help="layered + salt-body heterogeneous model (config 4)")
    ap.add_argument("--receivers", type=int, default=16)
    ap.add_argument("--shards", type=int, default=0,
                    help="run mesh-sharded over this many devices")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--vtk", type=str, default=None,
                    help="write PVD/VTU snapshots to this .pvd path")
    ap.add_argument("--vtk-every", type=int, default=50)
    ap.add_argument("--out", type=str, default=None,
                    help="seismogram npz output path")
    ap.add_argument("--report", type=str, default=None,
                    help="JSON run report path")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--vti", type=str, default=None,
                    help="'epsilon,delta,gamma' Thomsen parameters: VTI "
                         "anisotropic medium (3D, scheme lf, one device; "
                         "runs the einsum operators)")
    ap.add_argument("--qp", type=float, default=None,
                    help="P/bulk quality factor Q_kappa (viscoelastic "
                         "attenuation; requires --scheme upwind-rk4)")
    ap.add_argument("--qs", type=float, default=None,
                    help="S/shear quality factor Q_mu (viscoelastic "
                         "attenuation; requires --scheme upwind-rk4)")
    ap.add_argument("--pml", type=float, default=None,
                    help="C-PML width (domain units) on the absorbing "
                         "sides, replacing the Cerjan sponge (one device, "
                         "einsum RK4 path; beyond-parity — the reference "
                         "had characteristic BCs only)")
    ap.add_argument("--scheme", choices=["lf", "upwind-rk4"], default="lf",
                    help="'lf': staggered leapfrog + central flux (reference "
                         "parity); 'upwind-rk4': Godunov flux + RK4 "
                         "(dissipative, optimal odd-degree orders)")
    ap.add_argument("--impl", choices=["auto", "einsum", "xla_roll", "triton"],
                    default="auto",
                    help="operator engine of the LF path (ops/select.py): "
                         "'auto' = the fused Triton kernel on a GPU, the "
                         "XLA operators elsewhere; 'einsum' = the oracle")
    args = ap.parse_args(argv)

    if args.shards and args.cpu:
        # provision virtual CPU devices before the backend initializes
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.shards}"
            ).strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_jax.ops import Material, build_params, n_sig_for
    from seigen_jax.solver import (
        PointSource, State, absorbing_bc_fn, build_receivers, build_sources,
        cfl_dt, line, run, sponge_mask,
    )
    from seigen_jax.solver.models import Layer, add_ellipsoid_body, layered_model
    from seigen_jax.utils import (
        PVDWriter, RegionTimer, load_checkpoint, save_checkpoint,
        write_run_report,
    )

    dtype = jnp.float64 if args.f64 else jnp.float32
    dim = args.dim
    timer = RegionTimer()

    with timer.region("setup"):
        if args.mesh:
            from seigen_jax.mesh.gmsh_io import read_msh
            from seigen_jax.mesh.recover import recover_structure

            topo = read_msh(args.mesh)
            topo = recover_structure(topo)  # exact-or-nothing: lattice
            # meshes in disguise re-enter the fast structured pipelines
            if topo.structure is not None:
                print(f"recovered structure: grid={topo.structure[0]} "
                      f"m={topo.structure[1]}")
            dim = topo.dim
            extents = topo.extents
        else:
            extents = ((0.0, 2.0), (0.0, 1.0)) if dim == 2 else (
                (0.0, 1.0), (0.0, 1.0), (0.0, 1.0))
            if dim == 2:
                topo = rect_mesh(2 * args.n, args.n, lx=2.0, ly=1.0)
            else:
                topo = box_mesh(args.n, args.n, args.n)
        if dim == 2:
            free = [(1, "hi")]
            absorb = [(0, "lo"), (0, "hi"), (1, "lo")]
        else:
            free = [(2, "hi")]
            absorb = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]

        def frac(fr):  # extent-relative positions (imported meshes too)
            return tuple(lo + f * (hi - lo)
                         for f, (lo, hi) in zip(fr, extents))

        if dim == 2:
            src_pos = frac((0.5, 0.8))
            rec_a, rec_b = frac((0.1, 0.95)), frac((0.9, 0.95))
        else:
            src_pos = frac((0.5, 0.5, 0.8))
            rec_a, rec_b = frac((0.1, 0.5, 0.95)), frac((0.9, 0.5, 0.95))
        bc_groups = None
        if args.bc_free or args.bc_absorb:
            from seigen_jax.mesh.discrete import BC_ABSORB, BC_FREE

            bc_groups = {}
            for name in (args.bc_free or "").split(","):
                if name:
                    bc_groups[name] = BC_FREE
            for name in (args.bc_absorb or "").split(","):
                if name:
                    bc_groups[name] = BC_ABSORB
        dm = build_discrete(
            topo, args.degree, bc_fn=absorbing_bc_fn(extents, free),
            bc_groups=bc_groups)

        if args.layered:
            depth_hi = extents[-1][1]
            layers = [
                Layer(bottom=0.6 * depth_hi, top=depth_hi * 1.01,
                      rho=1.0, vp=1.5, vs=0.8),
                Layer(bottom=0.3 * depth_hi, top=0.6 * depth_hi,
                      rho=1.2, vp=2.5, vs=1.4),
                Layer(bottom=-0.01, top=0.3 * depth_hi,
                      rho=1.5, vp=3.5, vs=2.0),
            ]
            mat = layered_model(dm, layers)
            center = (1.0, 0.45) if dim == 2 else (0.5, 0.5, 0.45)
            radii = (0.3, 0.15) if dim == 2 else (0.2, 0.2, 0.12)
            mat = add_ellipsoid_body(dm, mat, center, radii,
                                     rho=2.1, vp=4.5, vs=2.6)
        else:
            mat = Material(rho=1.0, vp=2.0, vs=1.0)

        aniso_C = None
        vp_max = float(np.asarray(mat.vp).max())
        if args.vti:
            if dim != 3:
                raise SystemExit("--vti needs a 3D run")
            if args.scheme != "lf":
                raise SystemExit("--vti supports --scheme lf")
            if args.shards:
                raise SystemExit("--vti with --shards is not supported: "
                                 "the sharded path runs isotropic "
                                 "operators only")
            from seigen_jax.ops.anisotropic import vti_stiffness

            eps_, del_, gam_ = (float(x) for x in args.vti.split(","))
            C = vti_stiffness(np.asarray(mat.vp), np.asarray(mat.vs),
                              np.asarray(mat.rho), eps_, del_, gam_)
            aniso_C = np.broadcast_to(C, (dm.num_elements, 6, 6))
            # CFL bound: phase speeds <= sqrt(||C||_F / rho)
            fro = np.sqrt((aniso_C**2).sum(axis=(1, 2))).max()
            vp_max = max(vp_max,
                         float(np.sqrt(fro / np.asarray(mat.rho).min())))
            print(f"VTI: epsilon={eps_} delta={del_} gamma={gam_} "
                  f"(vmax bound {vp_max:.2f})")
        h = float(dm.h.min())
        f0 = args.f0 if args.f0 else 0.2 * vp_max / h / (args.degree + 1)
        p = build_params(dm, mat, dtype=dtype)
        src = build_sources(
            dm, [PointSource(position=src_pos, f0=f0, radius=2 * h)],
            dtype=dtype, mat=mat)
        rcv = build_receivers(
            dm, line(rec_a, rec_b, args.receivers), dtype=dtype)
        damp = jnp.asarray(sponge_mask(dm, absorb, width=0.15), dtype=dtype)
        dt = cfl_dt(h, vp_max, args.degree, args.cfl)
        n_steps = int(np.ceil(args.T / dt))
        E, n_p = dm.num_elements, dm.re.n_p

        resume_extras = {}
        if args.resume:
            st, step0, _ckmeta = load_checkpoint(args.resume, dtype=dtype)
            resume_extras = _ckmeta.get("_extras", {})
        else:
            st, step0 = State(
                u=jnp.zeros((E, n_p, dim), dtype=dtype),
                s=jnp.zeros((E, n_p, n_sig_for(dim)), dtype=dtype),
            ), 0

    print(f"E={E} dof={E*n_p*(dim+n_sig_for(dim))} dt={dt:.3e} "
          f"steps={n_steps} f0={f0:.1f}")
    from seigen_jax.ops.select import choose_impl, make_ops, resolve_impl

    platform = jax.devices()[0].platform
    engine = choose_impl(
        platform, dm.topology.structure is not None, dim=dim,
        degree=args.degree, dtype=dtype, scheme=args.scheme,
        aniso=aniso_C is not None, pml=args.pml is not None,
        shards=args.shards)
    if engine in ("einsum", "xla_roll", "triton") and aniso_C is None:
        try:
            engine = resolve_impl(args.impl, platform, dm, dtype)
        except ValueError as e:
            raise SystemExit(f"--impl {args.impl}: {e}")
    elif args.impl not in ("auto", "einsum"):
        raise SystemExit(f"--impl {args.impl} applies to the one-device "
                         f"isotropic LF path; this run uses {engine!r}")
    print(f"impl: {engine}")

    seis_chunks = []
    if args.pml is not None:
        # C-PML branch: direction-split einsum operators + RK4 memory-
        # variable integration (solver/pml.py).  The PML backs onto the
        # characteristic absorbing faces already set by bc_fn, which mop
        # up the residual normal-incidence energy at the outer boundary.
        if args.shards or args.scheme != "lf" or args.vti or (
                args.qp is not None or args.qs is not None):
            raise SystemExit("--pml is single-chip, isotropic, elastic "
                             "(no --shards/--vti/--qp/--qs; its stepper "
                             "is its own RK4, not --scheme)")
        if args.checkpoint or args.resume:
            raise SystemExit("--pml does not support checkpoint/resume yet")
        from seigen_jax.solver import cpml_init, cpml_profiles, make_cpml_rhs
        from seigen_jax.solver.pml import run_cpml

        dprof, aprof = cpml_profiles(dm, absorb, args.pml, vp_max, f0=f0)
        rhs = make_cpml_rhs(p, dprof, aprof, src=src)
        cst = cpml_init(p, st.u, st.s)
        print(f"cpml: width={args.pml}, RK4, {len(absorb)} sides")
        pvd = PVDWriter(args.vtk, dm) if args.vtk else None
        chunk = min(args.vtk_every if pvd else n_steps, n_steps)

        import functools

        @functools.partial(jax.jit, static_argnames=("k",))
        def advance_pml(cst, n0, k):
            return run_cpml(p, cst, dt, k, rhs, receivers=rcv, step0=n0)

        with timer.region("run"):
            n = 0
            while n < n_steps:
                k = min(chunk, n_steps - n)
                cst, ys = advance_pml(cst, jnp.asarray(n, jnp.int32), k)
                seis_chunks.append(np.asarray(ys))
                n += k
                if pvd and (n % args.vtk_every == 0 or n == n_steps):
                    pr = -np.asarray(cst.s)[..., :dim].mean(axis=-1)
                    pvd.write(n * dt, {"u": np.asarray(cst.u), "p": pr})
            jax.block_until_ready(cst.u)
        st = State(u=cst.u, s=cst.s)
    elif args.shards:
        print(f"sharded path: general (ppermute x{args.shards})")
        from seigen_jax.parallel import run_distributed

        with timer.region("run"):
            st, seis, _ = run_distributed(
                dm, mat, st, dt, n_steps - step0, n_devices=args.shards,
                order=args.order, sources=src, damp=damp, receivers=rcv,
                dtype=dtype, step0=step0,
            )
            seis_chunks.append(seis)
        step0 = n_steps
    else:
        pvd = PVDWriter(args.vtk, dm) if args.vtk else None
        chunk = (
            min(args.checkpoint_every if args.checkpoint else n_steps,
                args.vtk_every if pvd else n_steps, n_steps)
        )
        from seigen_jax.solver.timestep import make_step
        from seigen_jax.solver.receivers import sample

        visco = None
        if args.scheme == "upwind-rk4":
            from seigen_jax.ops.upwind import build_upwind_data

            wdata = build_upwind_data(dm, mat, dtype=dtype)
            if args.qp is not None or args.qs is not None:
                from seigen_jax.ops.viscoelastic import build_visco

                visco = build_visco(
                    p, args.qp or np.inf, args.qs or np.inf,
                    0.25 * f0, 2.5 * f0)
                print(f"viscoelastic: Qp={args.qp} Qs={args.qs} "
                      f"band=[{0.25*f0:.2f},{2.5*f0:.2f}] Hz")
            from seigen_jax.solver.rk4 import make_rk4_step

            if visco is not None:
                from seigen_jax.solver.rk4 import make_rk4_step_visco

                step_fn = make_rk4_step_visco(p, wdata, visco, dt,
                                              src=src, damp=damp)
            else:
                step_fn = make_rk4_step(p, wdata, dt, src=src, damp=damp)
        elif args.qp is not None or args.qs is not None:
            raise SystemExit("--qp/--qs need --scheme upwind-rk4")
        elif aniso_C is not None:
            from seigen_jax.ops.anisotropic import make_aniso_stress_op

            step_fn = make_step(
                p, dt, order=args.order, src=src, damp=damp,
                stress_op=make_aniso_stress_op(
                    jnp.asarray(aniso_C, dtype)))
        else:
            v_op, s_op = make_ops(engine, p, dm)
            step_fn = make_step(p, dt, order=args.order, src=src, damp=damp,
                                vel_op=v_op, stress_op=s_op)

        import functools

        if visco is not None:
            @functools.partial(jax.jit, static_argnames=("k",))
            def advance(st, xi, n0, k):
                def body(c, i):
                    s2, x2 = step_fn(c[0], c[1],
                                     (n0 + i).astype(dtype) * dt)
                    return (s2, x2), sample(rcv, s2.u)
                (s2, x2), ys = jax.lax.scan(body, (st, xi), jnp.arange(k))
                return s2, x2, ys
        else:
            @functools.partial(jax.jit, static_argnames=("k",))
            def advance(st, xi, n0, k):
                def body(s, i):
                    s2 = step_fn(s, (n0 + i).astype(dtype) * dt)
                    return s2, sample(rcv, s2.u)
                fin, ys = jax.lax.scan(body, st, jnp.arange(k))
                return fin, None, ys

        xi = None
        if visco is not None:
            xi = resume_extras.get(
                "xi",
                jnp.zeros((E, n_p, n_sig_for(dim), visco.L), dtype))
        with timer.region("run"):
            n = step0
            while n < n_steps:
                k = min(chunk, n_steps - n)
                st, xi, ys = advance(st, xi, jnp.asarray(n, dtype=jnp.int32),
                                     k)
                seis_chunks.append(np.asarray(ys))
                n += k
                if pvd and (n % args.vtk_every == 0 or n == n_steps):
                    pr = -np.asarray(st.s)[..., :dim].mean(axis=-1)
                    pvd.write(n * dt, {"u": np.asarray(st.u), "p": pr})
                if args.checkpoint and (
                    n % args.checkpoint_every == 0 or n == n_steps
                ):
                    save_checkpoint(
                        args.checkpoint, st, n, {"dt": dt, "T": args.T},
                        extras=None if xi is None else {"xi": xi})
            jax.block_until_ready(st.u)

    return _common_tail(args, st, seis_chunks, timer, dt, E, n_steps, f0,
                        rec_a, rec_b)


def _common_tail(args, st, seis_chunks, timer, dt, E, n_steps, f0,
                 rec_a, rec_b):
    """Seismogram save + report + finite-field check."""
    import numpy as np

    from seigen_jax.solver import line
    from seigen_jax.utils import write_run_report

    seis = np.concatenate(seis_chunks, axis=0) if seis_chunks else None
    if args.out and seis is not None:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        np.savez_compressed(
            args.out, seismograms=seis, dt=dt,
            receivers=line(rec_a, rec_b, args.receivers),
        )
        print(f"seismograms -> {args.out}")
    if args.report:
        write_run_report(
            args.report, vars(args), timer.report(),
            {"E": E, "n_steps": n_steps, "dt": dt, "f0": f0},
        )
    umax = float(np.abs(np.asarray(st.u)).max())
    print(f"done: steps={n_steps} max|u|={umax:.3e} "
          f"timings={json.dumps(timer.report())}")
    if not np.isfinite(umax):
        raise SystemExit("non-finite velocity field")
    return 0


if __name__ == "__main__":
    sys.exit(main())
