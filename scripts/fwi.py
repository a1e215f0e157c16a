#!/usr/bin/env python
"""Full-waveform inversion: recover velocity structure from surface
seismograms by descent through the differentiable solver.

Beyond-reference capability (the reference is forward-only): the
production loop (seigen_jax/solver/fwi.py) adds optax Adam/L-BFGS,
face-adjacency gradient smoothing, frequency continuation, bounds, and
vmapped multi-shot batching; gradients ride the roll-exchange einsum
path on structured meshes (the fastest differentiable formulation —
see solver/fwi.py docstring).

Examples:
  # 2D anomaly demo (round-2 parity):
  python scripts/fwi.py --n 24 --degree 2 --iters 30 --shots 4 --cpu
  # 3D salt-body recovery at E=82944 (the production demo):
  python scripts/fwi.py --dim 3 --n 24 --degree 1 --salt --iters 12 \
      --shots 4 --optimizer adam --bands 4,8 --T 1.4
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--receivers", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30,
                    help="iterations PER continuation band")
    ap.add_argument("--optimizer", choices=["adam", "lbfgs", "gd"],
                    default="adam")
    ap.add_argument("--lr", type=float, default=None,
                    help="adam step (default 0.01) or gd max-normalized "
                         "step (default 0.01)")
    ap.add_argument("--bands", type=str, default=None,
                    help="comma-separated low-pass cutoffs in Hz for "
                         "frequency continuation, e.g. '4,8' (a final "
                         "full-band stage is appended automatically)")
    ap.add_argument("--smooth", type=int, default=2,
                    help="gradient-smoother Jacobi iterations (0 = off)")
    ap.add_argument("--areal", action="store_true",
                    help="3D: shots on a sqrt(S) x sqrt(S) areal grid "
                         "and receivers on a sqrt(R) x sqrt(R) areal "
                         "patch (instead of the round-3 y=0.5 LINES — "
                         "line acquisition cannot resolve a 3D target "
                         "in y)")
    ap.add_argument("--vsp", type=int, default=0,
                    help="3D: add 4 vertical receiver strings of this "
                         "many receivers at the corners of the "
                         "acquisition patch — transmission through the "
                         "target constrains INTERIOR velocity, which "
                         "surface reflections alone do not")
    ap.add_argument("--precond", choices=["none", "illum"],
                    default="none",
                    help="gradient preconditioner; 'illum' (illumination "
                         "weighting) is not available: it needs the "
                         "custom-VJP gradient engine, which is not ported")
    ap.add_argument("--salt", action="store_true",
                    help="3D: layered background + salt body as the true "
                         "model; invert vp from the salt-free background")
    ap.add_argument("--T", type=float, default=1.2)
    ap.add_argument("--segment", type=int, default=None,
                    help="jax.checkpoint segment length (adjoint memory)")
    ap.add_argument("--batch", choices=["vmap", "map", "host"],
                    default="vmap",
                    help="shot batching: 'map' compiles one shot body "
                         "(S x smaller program); 'host' loops shots on "
                         "host, holding one shot's adjoint tape at a time")
    ap.add_argument("--inv-checkpoint", type=str, default=None,
                    help="inversion-state npz written every iteration; "
                         "with --inv-resume a killed inversion continues "
                         "bitwise from it")
    ap.add_argument("--inv-resume", action="store_true")
    ap.add_argument("--invert-q", action="store_true",
                    help="attenuation FWI demo: observed data from a "
                         "low-Q anomaly in the background ELASTIC model, "
                         "per-element (Q_kappa^-1, Q_mu^-1) inverted by "
                         "Adam through the viscoelastic upwind-RK4 scan "
                         "(make_visco_fwi_gradient)")
    ap.add_argument("--est-source", action="store_true",
                    help="source-wavelet estimation; not available: it "
                         "needs the custom-VJP gradient engine, which is "
                         "not ported")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None,
                    help="npz output (true/init/final vp, misfits)")
    args = ap.parse_args()

    if args.est_source or args.precond == "illum":
        raise SystemExit("--est-source and --precond illum need the "
                         "custom-VJP gradient engine, which is not ported "
                         "to this version; gradients run einsum AD")

    import jax

    from seigen_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
    from seigen_jax.ops import Material, build_params
    from seigen_jax.ops.select import XLA_STRUCTURED, make_ops
    from seigen_jax.ops.structured_exchange import detect_structured
    from seigen_jax.solver import (
        PointSource, State, absorbing_bc_fn, build_receivers, build_sources,
        cfl_dt, grid, line, sponge_mask,
    )
    from seigen_jax.solver.adjoint import with_material
    from seigen_jax.solver.fwi import invert
    from seigen_jax.solver.shots import run_shots, stack_shots

    dtype = jnp.float64 if args.f64 else jnp.float32
    t_setup = time.perf_counter()

    if args.dim == 2:
        extents = ((0.0, 2.0), (0.0, 1.0))
        dm = build_discrete(
            rect_mesh(2 * args.n, args.n, lx=2.0, ly=1.0), args.degree,
            bc_fn=absorbing_bc_fn(extents, free_sides=[(1, "hi")]))
        mat0 = Material(rho=1.0, vp=2.0, vs=1.0)
        vp_bg = None
        src_depth, rcv_depth = 0.9, 0.95
        shot_line = (0.3, 1.7)
        rcv_line = ((0.15, rcv_depth), (1.85, rcv_depth))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo")]
        vmax = 2.0
    else:
        extents = ((0.0, 1.0),) * 3
        dm = build_discrete(
            box_mesh(args.n, args.n, args.n), args.degree,
            bc_fn=absorbing_bc_fn(extents, free_sides=[(2, "hi")]))
        from seigen_jax.solver.models import (
            Layer, add_ellipsoid_body, layered_model)

        mat0 = layered_model(dm, [
            Layer(bottom=-0.01, top=0.5, rho=1.2, vp=2.4, vs=1.2),
            Layer(bottom=0.5, top=1.01, rho=1.0, vp=2.0, vs=1.0)])
        vp_bg = np.asarray(mat0.vp, np.float64)
        src_depth, rcv_depth = 0.85, 0.9
        shot_line = (0.25, 0.75)
        rcv_line = ((0.1, 0.5, rcv_depth), (0.9, 0.5, rcv_depth))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        vmax = 3.2 if args.salt else 2.4

    E, n_p = dm.num_elements, dm.re.n_p
    h = float(dm.h.min())
    cent = np.asarray(dm.coords.mean(axis=1))
    p0 = build_params(dm, mat0, dtype=dtype)

    # true model
    if args.dim == 2:
        anom = -0.3 * np.exp(
            -(((cent[:, 0] - 1.0) ** 2 + (cent[:, 1] - 0.5) ** 2)
              / (2 * 0.15**2)))
        vp_true = jnp.asarray(2.0 + anom, dtype)
    elif args.salt:
        mat_true = add_ellipsoid_body(
            dm, mat0, center=(0.5, 0.5, 0.55), radii=(0.22, 0.22, 0.16),
            rho=1.4, vp=3.0, vs=1.5)
        vp_true = jnp.asarray(mat_true.vp, dtype)
    else:
        anom = -0.3 * np.exp(
            -np.sum((cent - 0.5) ** 2, axis=1) / (2 * 0.15**2))
        vp_true = jnp.asarray(vp_bg + anom, dtype)

    f0 = 0.15 * vmax / h / (args.degree + 1)
    if args.dim == 2:
        shots = stack_shots([
            build_sources(dm, [PointSource(
                position=(float(x), src_depth), f0=f0, radius=2 * h)],
                dtype=dtype)
            for x in np.linspace(*shot_line, args.shots)])
    else:
        if args.areal:
            g = max(1, int(round(np.sqrt(args.shots))))
            shot_pos = grid(shot_line, shot_line, g, g, src_depth)
            args.shots = g * g
        else:
            shot_pos = [(float(x), 0.5, src_depth)
                        for x in np.linspace(*shot_line, args.shots)]
        shots = stack_shots([
            build_sources(dm, [PointSource(
                position=tuple(map(float, pos)), f0=f0, radius=2 * h)],
                dtype=dtype)
            for pos in shot_pos])
    if args.dim == 3 and (args.areal or args.vsp):
        pts = []
        if args.areal:
            gr = max(2, int(round(np.sqrt(args.receivers))))
            pts.append(grid((0.1, 0.9), (0.1, 0.9), gr, gr, rcv_depth))
        else:
            pts.append(line(*rcv_line, args.receivers))
        if args.vsp:
            # corner strings kept outside the 0.15 sponges and just off
            # the salt flank (salt x,y extent ~[0.28, 0.72])
            for x, y in ((0.25, 0.25), (0.25, 0.75),
                         (0.75, 0.25), (0.75, 0.75)):
                pts.append(line((x, y, 0.2), (x, y, 0.8), args.vsp))
        rcv_pts = np.concatenate([np.asarray(p, float) for p in pts])
    else:
        rcv_pts = line(*rcv_line, args.receivers)
    rcv = build_receivers(dm, rcv_pts, dtype=dtype)
    damp = jnp.asarray(sponge_mask(dm, sponge, width=0.15), dtype)
    dt = cfl_dt(h, vmax, args.degree, 0.4)
    n_steps = int(np.ceil(args.T / dt))
    if args.segment:
        n_steps -= n_steps % args.segment
    st0 = State(u=jnp.zeros((E, n_p, args.dim), dtype),
                s=jnp.zeros((E, n_p, 3 * (args.dim - 1)), dtype))

    if args.invert_q:
        # ---- attenuation FWI (Q^-1 tomography) ----------------------
        import optax

        from seigen_jax.ops.upwind import build_upwind_data
        from seigen_jax.ops.viscoelastic import build_visco
        from seigen_jax.solver.adjoint import make_visco_fwi_gradient
        from seigen_jax.solver.fwi import make_smoother
        from seigen_jax.solver.rk4 import run_rk4_visco

        w = build_upwind_data(dm, mat0, dtype=dtype)
        f_band = (f0 / 3.0, 3.0 * f0)
        # true model: background Q=80 with a strong low-Q (gas-cloud-like)
        # anomaly Q=10 ON the source-receiver propagation path (the
        # direct waves run near src_depth; a mid-domain anomaly is
        # invisible to this surface acquisition)
        c0 = cent.mean(axis=0)
        c0[-1] = src_depth
        r2 = np.sum((cent - c0) ** 2, axis=1)
        qinv_true = 1.0 / 80.0 + (1.0 / 10.0 - 1.0 / 80.0) * np.exp(
            -r2 / (2 * 0.2**2))
        v_true = build_visco(p0, 1.0 / qinv_true, 1.0 / qinv_true, *f_band)

        def shot_k(k):
            return jax.tree.map(lambda x: x[k], shots)

        synth = jax.jit(lambda sk, v: run_rk4_visco(
            p0, w, v, st0, dt, n_steps, src=sk, damp=damp,
            receivers=rcv, segment=args.segment)[2])
        obs = [np.asarray(synth(shot_k(k), v_true))
               for k in range(args.shots)]
        print(f"setup+observed(visco): "
              f"{time.perf_counter() - t_setup:.1f} s", flush=True)

        vg, init_theta = make_visco_fwi_gradient(
            p0, w, st0, dt, n_steps, shot_k(0), rcv, jnp.asarray(obs[0]),
            f_band, q0=80.0, damp=damp, segment=args.segment)
        theta = init_theta()
        smooth = make_smoother(p0, iters=args.smooth)
        # qinv lives in [1e-4, 0.2]; Adam's unit-RMS steps need a small
        # lr to stay a few-% relative move per iteration
        opt = optax.adam(args.lr if args.lr is not None else 5e-4)
        ost = opt.init(theta)
        misfits = []
        t_inv = time.perf_counter()
        for it in range(args.iters):
            tot_v, tot_g = 0.0, None
            for k in range(args.shots):
                v, g = vg(theta, shot_k(k), jnp.asarray(obs[k]))
                tot_v += float(v)
                tot_g = g if tot_g is None else jax.tree.map(
                    jnp.add, tot_g, g)
            tot_g = jax.tree.map(smooth, tot_g)
            upd, ost = opt.update(tot_g, ost, theta)
            theta = jax.tree.map(
                lambda t, u: jnp.clip(t + u, 1e-4, 0.2), theta, upd)
            misfits.append(tot_v)
            print(f"q-iter={it} misfit={tot_v:.4e}", flush=True)
        qinv = np.asarray(0.5 * (theta["qinv_kappa"] + theta["qinv_mu"]))
        region = qinv_true > 1.5 / 80.0
        if not region.any():
            region = np.ones(E, dtype=bool)
        err0 = float(np.abs(1.0 / 80.0 - qinv_true)[region].mean())
        err = float(np.abs(qinv - qinv_true)[region].mean())
        summary = {
            "mode": "invert_q", "E": E, "n_steps": n_steps,
            "shots": args.shots, "misfit_first": misfits[0],
            "misfit_last": misfits[-1],
            "qinv_err_init": err0, "qinv_err_final": err,
            "qinv_err_reduction": err / max(err0, 1e-30),
            "wall_s": time.perf_counter() - t_inv,
        }
        print(json.dumps(summary))
        if args.out:
            np.savez_compressed(
                args.out, qinv_true=qinv_true, qinv_final=qinv,
                misfits=np.asarray(misfits), centroids=cent)
            print(f"model -> {args.out}")
        assert misfits[-1] < misfits[0]
        return 0

    # gradient formulation: reverse-mode AD through the XLA operators
    grad_ops = XLA_STRUCTURED if detect_structured(dm) is not None else (
        "einsum")
    vel_op, stress_op = make_ops(grad_ops, p0, dm)
    print(f"E={E} steps={n_steps} shots={args.shots} f0={f0:.1f} "
          f"grad_ops={grad_ops}")

    # observed data from the true model
    p_true = with_material(p0, vp=vp_true)
    fwd = lambda p: run_shots(  # noqa: E731
        p, st0, dt, n_steps, shots, receivers=rcv, damp=damp,
        segment=args.segment, vel_op=vel_op, stress_op=stress_op,
        batch=args.batch)
    # host mode jits per shot internally
    _, observed = (fwd(p_true) if args.batch == "host"
                   else jax.jit(fwd)(p_true))
    observed = jax.block_until_ready(observed)
    print(f"setup+observed: {time.perf_counter() - t_setup:.1f} s",
          flush=True)

    bands = None
    if args.bands:
        bands = tuple(float(b) for b in args.bands.split(",")) + (None,)
    lr = args.lr if args.lr is not None else 0.01
    lo = float(np.asarray(vp_true).min()) - 0.3
    hi = float(np.asarray(vp_true).max()) + 0.3

    res = invert(
        p0, st0, dt, n_steps, shots, rcv, observed,
        fields=("vp",), optimizer=args.optimizer, lr=lr,
        iters=args.iters, bands=bands, smooth_iters=args.smooth,
        bounds={"vp": (lo, hi)}, damp=damp, segment=args.segment,
        vel_op=vel_op, stress_op=stress_op, batch=args.batch,
        checkpoint_path=args.inv_checkpoint, resume=args.inv_resume,
        log=lambda s: print(s, flush=True))

    vp0 = jnp.sqrt((p0.lam + 2 * p0.mu) * p0.inv_rho)
    vp = res.theta["vp"]
    region = np.abs(np.asarray(vp_true) - np.asarray(vp0)) > 0.05
    if not region.any():
        region = np.ones(E, dtype=bool)
    err0 = float(jnp.abs(vp0 - vp_true)[region].mean())
    err = float(jnp.abs(vp - vp_true)[region].mean())
    summary = {
        "E": E, "n_steps": n_steps, "shots": args.shots,
        "optimizer": args.optimizer, "bands": args.bands,
        "misfit_first": res.misfits[0], "misfit_last": res.misfits[-1],
        "band_log": res.bands,
        "model_err_init": err0, "model_err_final": err,
        "model_err_reduction": err / max(err0, 1e-30),
        "wall_s": res.wall_s,
    }
    print(json.dumps(summary))
    if args.out:
        np.savez_compressed(
            args.out, vp_true=np.asarray(vp_true),
            vp_init=np.asarray(vp0), vp_final=np.asarray(vp),
            misfits=np.asarray(res.misfits), centroids=cent)
        print(f"model -> {args.out}")
    assert res.misfits[-1] < res.misfits[0] or err < err0
    return 0


if __name__ == "__main__":
    sys.exit(main())
