#!/usr/bin/env python
"""Surface-topography demo: explosive source under a CURVED free surface.

Exercises the curvilinear (isoparametric) element path end-to-end
(`ops/curvilinear.py`): a 2D km-scale domain whose free surface carries a
smooth topography profile, an explosive Ricker source at depth, and a
receiver line riding the curved surface.  Beyond-reference capability —
the reference's production meshes are straight-sided (SURVEY.md §2 "Mesh
handling": Firedrake P1 coordinates); curved topography is the standard
use-case isoparametric elements exist for.

Geometry: the flat rect mesh is deformed by a z-only map that is the
IDENTITY below ``z0`` and blends (smoothstep) into the topography profile
at the surface.  That keeps the deep source projection, the side/bottom
sponge masks, and the absorbing boundaries exact in flat coordinates
(the map moves only z near the top, where the surface is free), while the
free-surface faces — where the physics happens — are genuinely curved with
per-quadrature-point Nanson normals.

Receiver positions are given in flat parameter coordinates; the ones at
z = lz ride the physical topography (their mapped positions are stored in
the seismogram npz).

Example:
  python scripts/topography.py --nx 48 --nz 24 --degree 3 --T 0.8 \\
      --amp 0.08 --vtk out/topo.pvd --out topo_seis.npz
"""

import argparse
import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def smoothstep(s):
    import numpy as np

    s = np.clip(s, 0.0, 1.0)
    return s * s * (3.0 - 2.0 * s)


def topo_map(profile, z0: float, lz: float):
    """z-only diffeomorphism: identity for z <= z0, full profile at z = lz."""
    import numpy as np

    def f(x):
        out = np.array(x, dtype=np.float64, copy=True)
        blend = smoothstep((x[:, 1] - z0) / (lz - z0))
        out[:, 1] = x[:, 1] + blend * profile(x[:, 0])
        return out

    return f


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--lx", type=float, default=2.0)
    ap.add_argument("--lz", type=float, default=1.0)
    ap.add_argument("--degree", type=int, default=3, choices=[1, 2, 3, 4, 5, 6])
    ap.add_argument("--T", type=float, default=0.8)
    ap.add_argument("--amp", type=float, default=0.08,
                    help="topography amplitude (fraction of lz ~ hill height)")
    ap.add_argument("--profile", choices=["sin", "hill"], default="hill",
                    help="surface shape: sinusoid or central Gaussian hill")
    ap.add_argument("--z0", type=float, default=None,
                    help="depth above which the curvature blends in "
                    "(default 0.55*lz)")
    ap.add_argument("--f0", type=float, default=None)
    ap.add_argument("--cfl", type=float, default=0.3,
                    help="CFL number (curved elements shrink the margin; "
                    "the bound uses the mapped minimum edge)")
    ap.add_argument("--receivers", type=int, default=32)
    ap.add_argument("--vtk", type=str, default=None)
    ap.add_argument("--vtk-every", type=int, default=50)
    ap.add_argument("--out", type=str, default=None,
                    help="seismogram npz path")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
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
    from seigen_jax.ops.curvilinear import (
        build_curvi, curved_coords, make_curvi_ops)
    from seigen_jax.solver import (
        PointSource, State, absorbing_bc_fn, cfl_dt, run)
    from seigen_jax.solver.damping import sponge_mask
    from seigen_jax.solver.receivers import build_receivers, line
    from seigen_jax.solver.source import build_sources
    from seigen_jax.utils.profiling import RegionTimer

    dtype = jnp.float64 if args.f64 else jnp.float32
    lx, lz = args.lx, args.lz
    z0 = args.z0 if args.z0 is not None else 0.55 * lz
    mat = Material(rho=1.8, vp=2.5, vs=1.3)

    tm = RegionTimer()
    with tm.region("setup"):
        dm = build_discrete(
            rect_mesh(args.nx, args.nz, lx=lx, ly=lz), args.degree,
            bc_fn=absorbing_bc_fn(((0.0, lx), (0.0, lz)),
                                  free_sides=[(1, "hi")]))
        if args.profile == "sin":
            prof = lambda x: args.amp * lz * np.sin(2 * np.pi * x / lx)
        else:
            prof = lambda x: args.amp * lz * np.exp(
                -((x - 0.5 * lx) ** 2) / (2 * (0.15 * lx) ** 2))
        phi = topo_map(prof, z0, lz)
        X = curved_coords(dm, phi)
        cp = build_curvi(dm, X, dtype=dtype)
        vop, sop = make_curvi_ops(cp)
        p = build_params(dm, mat, dtype=dtype)

        # CFL from the MAPPED minimum edge length (curved elements shrink)
        cverts = phi(
            dm.topology.vertices[dm.topology.cells].reshape(-1, 2)
        ).reshape(-1, 3, 2)
        e01 = np.linalg.norm(cverts[:, 0] - cverts[:, 1], axis=1)
        e12 = np.linalg.norm(cverts[:, 1] - cverts[:, 2], axis=1)
        e20 = np.linalg.norm(cverts[:, 2] - cverts[:, 0], axis=1)
        h_min = float(np.minimum(np.minimum(e01, e12), e20).min())

        h = float(dm.h.max())
        f0 = args.f0 if args.f0 else 0.2 * mat.vp / h / (args.degree + 1)
        src_z = 0.4 * lz
        assert src_z < z0, "source must sit in the identity region"
        src = build_sources(
            dm, [PointSource(position=(0.5 * lx, src_z), f0=f0,
                             radius=2 * h)],
            dtype=dtype)
        damp = jnp.asarray(
            sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")],
                        width=0.15 * lz), dtype)

        # receivers ride the curved surface (parameter z just below lz)
        rpts = line((0.06 * lx, 0.999 * lz), (0.94 * lx, 0.999 * lz),
                    args.receivers)
        rcv = build_receivers(dm, rpts, dtype=dtype)
        rcv_phys = phi(rpts)

        dt = cfl_dt(h_min, float(mat.vp), args.degree, args.cfl)
        n_steps = int(np.ceil(args.T / dt))
        dt = args.T / n_steps
        st = State(
            u=jnp.zeros((dm.num_elements, dm.re.n_p, 2), dtype),
            s=jnp.zeros((dm.num_elements, dm.re.n_p, 3), dtype))

    print(f"E={dm.num_elements} dof={dm.num_elements * dm.re.n_p * 5} "
          f"dt={dt:.3e} steps={n_steps} f0={f0:.1f} amp={args.amp}")

    pvd = None
    if args.vtk:
        from seigen_jax.utils.io_vtk import PVDWriter

        pvd = PVDWriter(args.vtk, dm, verts=cverts.reshape(-1, 3, 2))

    with tm.region("run"):
        seis_chunks = []
        chunk = min(args.vtk_every if pvd else n_steps, n_steps)
        n = 0
        while n < n_steps:
            k = min(chunk, n_steps - n)
            st, ys = run(p, st, dt, k, order=4, src=src, damp=damp,
                         receivers=rcv, record_pressure=True,
                         vel_op=vop, stress_op=sop, step0=n)
            seis_chunks.append(np.asarray(ys))
            n += k
            if pvd:
                pvd.write(n * dt, {"u": np.asarray(st.u)})
        seis = np.concatenate(seis_chunks, axis=0)

    max_u = float(np.abs(np.asarray(st.u)).max())
    assert np.isfinite(max_u), "solution blew up"
    print(f"done: steps={n_steps} max|u|={max_u:.3e} "
          f"timings={json.dumps(tm.report())}")

    if args.out:
        np.savez(args.out, seis=seis, dt=dt,
                 receivers=rpts, receivers_phys=rcv_phys,
                 f0=f0, amp=args.amp, profile=args.profile)
        print(f"seismograms -> {args.out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"E": dm.num_elements, "n_steps": n_steps, "dt": dt,
                       "f0": f0, "max_u": max_u, "amp": args.amp,
                       "timings": tm.report()}, f, indent=1)


if __name__ == "__main__":
    main()
