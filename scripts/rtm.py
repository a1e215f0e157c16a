"""Reverse-time migration: image reflectors with the adjoint stack.

The adjoint-state identity makes RTM a one-evaluation special case of
FWI (docs/fwi.md): record observed data in the TRUE (reflector-bearing)
model, evaluate the seismogram-misfit gradient in the smooth background,
and the material gradient is the zero-lag cross-correlation image of the
forward and back-propagated wavefields — reflectivity up to sign and
illumination.  The gradient is einsum AD (solver/adjoint.py); what
this script adds is the imaging post-processing
(`seigen_jax/solver/imaging.py`): acquisition mute + graph-Laplacian
low-wavenumber artifact removal.

Demo model: homogeneous background; the true model adds a sharp flat
reflector below an interface depth — by default an IMPEDANCE (rho) step
imaged through the rho gradient, which has pure scattering sensitivity
(see --reflect).  The JSON summary reports how tightly the filtered
image localizes the interface: |image|-weighted mean depth + RMS spread
vs truth, and the energy fraction within half a wavelength of the
horizon.  Measured at the defaults (2D, n=16+, >=3 shots): z_error
~0.04-0.06, focus ~0.8.  With --free-top the image also shows the
physical source ghost (a polarity-flipped phantom ~v*t_ghost/2 below
the true horizon — measured and explained in the --free-top help).

The reference framework was forward-only (SURVEY.md §2); imaging is
beyond-parity capability.  Run on CPU: `--cpu --f64 --n 16`; on a GPU,
e.g. `--dim 3 --areal`.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--receivers", type=int, default=24)
    ap.add_argument("--T", type=float, default=None,
                    help="record length (default: two-way time + wavelet)")
    ap.add_argument("--f0", type=float, default=None)
    ap.add_argument("--z-reflector", type=float, default=0.35,
                    help="interface depth coordinate (vertical axis)")
    ap.add_argument("--contrast", type=float, default=0.3,
                    help="relative jump of --reflect below the reflector")
    ap.add_argument("--reflect", choices=["rho", "vp"], default="rho",
                    help="which field carries the reflector. 'rho' is an "
                         "impedance-only contrast: kinematics stay exact "
                         "in the background and the rho-gradient has pure "
                         "scattering (isochron) sensitivity — the "
                         "textbook RTM setting.  'vp' adds the smooth "
                         "transmission (banana) kernel to the image; "
                         "crank --filter-iters to suppress it")
    ap.add_argument("--areal", action="store_true",
                    help="3D: shots on a sqrt(S) x sqrt(S) grid and "
                         "receivers on an areal patch.  LINE acquisition "
                         "cannot image a 3D volume: the round-3 artifact "
                         "put 79%% of windowed image energy off the "
                         "acquisition plane as shallow low-wavenumber "
                         "smear, pulling z_imaged 0.23 shallow")
    ap.add_argument("--free-top", action="store_true",
                    help="free surface on top (default absorbing: the "
                         "ghost-free idealization — a free top adds "
                         "source/receiver ghosts that back-project as "
                         "polarity-flipped phantom reflectors ~v*t_ghost/2 "
                         "deeper; physical, but muddies the demo metric)")
    ap.add_argument("--segment", type=int, default=None,
                    help="checkpoint-segment length for the adjoint")
    ap.add_argument("--filter-iters", type=int, default=1,
                    help="graph-Laplacian high-pass applications")
    ap.add_argument("--illum-comp", choices=["source", "none"],
                    default="source",
                    help="divide the image by the source-side "
                         "illumination (one forward per shot in the "
                         "background).  In 3D the forward-field energy "
                         "decays r^-2 (vs r^-1 in 2D), so an "
                         "uncompensated image is shallow-weighted — "
                         "this is the round-4 fix for the round-3 "
                         "z_imaged bias")
    ap.add_argument("--mute-radius", type=float, default=0.18,
                    help="acquisition mute radius around sources/receivers")
    ap.add_argument("--out", type=str, default=None,
                    help="npz output (image, filtered, models, centroids)")
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

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
    from seigen_jax.solver import (
        PointSource, State, absorbing_bc_fn, build_receivers, build_sources,
        cfl_dt, grid, line, sponge_mask,
    )
    from seigen_jax.solver.imaging import (
        acquisition_mute, laplacian_filter, normalize, rtm_image,
    )
    from seigen_jax.solver.shots import stack_shots

    dtype = jnp.float64 if args.f64 else jnp.float32
    t0_wall = time.perf_counter()
    dim, n, q = args.dim, args.n, args.degree
    zr = args.z_reflector

    free = [(dim - 1, "hi")] if args.free_top else []
    if args.free_top:
        src_depth, rcv_depth, sp_w = 0.85, 0.9, 0.15
    else:  # acquisition must sit below the top sponge
        src_depth, rcv_depth, sp_w = 0.76, 0.8, 0.12
    shot_line = (0.25, 0.75)
    if dim == 2:
        extents = ((0.0, 1.0), (0.0, 1.0))
        dm = build_discrete(
            rect_mesh(n, n), q,
            bc_fn=absorbing_bc_fn(extents, free_sides=free))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo")]
        rcv_line = ((0.1, rcv_depth), (0.9, rcv_depth))
    else:
        extents = ((0.0, 1.0),) * 3
        dm = build_discrete(
            box_mesh(n, n, n), q,
            bc_fn=absorbing_bc_fn(extents, free_sides=free))
        sponge = [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")]
        rcv_line = ((0.1, 0.5, rcv_depth), (0.9, 0.5, rcv_depth))
    if not args.free_top:
        sponge.append((dim - 1, "hi"))

    E, n_p = dm.num_elements, dm.re.n_p
    h = float(dm.h.min())
    cent = np.asarray(dm.coords.mean(axis=1))
    depth_ax = dim - 1

    # background: homogeneous; true: +contrast of --reflect below zr
    below = cent[:, depth_ax] < zr
    bg = {"vp": np.full(E, 2.0), "rho": np.ones(E)}
    true_f = dict(bg)
    true_f[args.reflect] = bg[args.reflect] * (1.0 + args.contrast * below)
    mat_bg = Material(rho=1.0, vp=2.0, vs=1.0)
    p0 = build_params(dm, mat_bg, dtype=dtype)
    vmax = float(true_f["vp"].max())
    field = args.reflect  # image the field that carries the reflector

    f0 = args.f0 or 0.3 * vmax / h / (q + 1)
    # two-way time from the deepest shot to the reflector and back up to
    # the receivers, plus the wavelet onset
    T = args.T or ((src_depth - zr) + (rcv_depth - zr)) / 2.0 + 2.0 / f0
    dt = cfl_dt(h, vmax, q, 0.4)
    n_steps = int(np.ceil(T / dt))
    if args.segment:
        n_steps -= n_steps % args.segment

    def pos(x):
        return (float(x), src_depth) if dim == 2 else (
            float(x), 0.5, src_depth)

    if dim == 3 and args.areal:
        g = max(1, int(round(np.sqrt(args.shots))))
        shot_pos = [tuple(map(float, p))
                    for p in grid(shot_line, shot_line, g, g, src_depth)]
        args.shots = g * g
        gr = max(2, int(round(np.sqrt(args.receivers))))
        rcv_pts = grid((0.1, 0.9), (0.1, 0.9), gr, gr, rcv_depth)
        args.receivers = gr * gr
    else:
        shot_pos = [pos(x) for x in np.linspace(*shot_line, args.shots)]
        rcv_pts = line(*rcv_line, args.receivers)
    shots = stack_shots([
        build_sources(dm, [PointSource(position=p, f0=f0,
                                       radius=1.5 * h)], dtype=dtype)
        for p in shot_pos])
    rcv = build_receivers(dm, rcv_pts, dtype=dtype)
    damp = jnp.asarray(sponge_mask(dm, sponge, width=sp_w), dtype)
    st0 = State(u=jnp.zeros((E, n_p, dim), dtype),
                s=jnp.zeros((E, n_p, 3 * (dim - 1)), dtype))
    print(f"E={E} steps={n_steps} shots={args.shots} f0={f0:.2f}",
          flush=True)

    theta_bg = {field: jnp.asarray(bg[field], dtype)}
    theta_true = {field: jnp.asarray(true_f[field], dtype)}
    from seigen_jax.solver.adjoint import (
        run_segmented, seismogram_misfit, with_material)

    def run(theta, src_k, obs_k):
        p = with_material(p0, **theta)
        return seismogram_misfit(
            p, st0, dt, n_steps, src_k, rcv, obs_k,
            damp=damp, segment=args.segment)

    fwd_one = jax.jit(lambda theta, src_k: run_segmented(
        with_material(p0, **theta), st0, dt, n_steps,
        segment=args.segment, src=src_k, damp=damp,
        receivers=rcv)[1])
    vg_one = jax.jit(jax.value_and_grad(run))
    src_np = jax.tree.map(np.asarray, shots)
    shot_k = lambda k: jax.tree.map(  # noqa: E731
        lambda x, k=k: jnp.asarray(x[k]), src_np)
    observed = [np.asarray(fwd_one(theta_true, shot_k(k)))
                for k in range(args.shots)]

    def vg(theta):
        tot_v, tot_g = 0.0, None
        for k in range(args.shots):
            v, g = vg_one(theta, shot_k(k), jnp.asarray(observed[k]))
            g = jax.tree.map(np.asarray, g)
            tot_v += float(v)
            tot_g = g if tot_g is None else jax.tree.map(
                np.add, tot_g, g)
        return tot_v, tot_g

    misfit, raw = rtm_image(vg, theta_bg, field=field)

    if args.illum_comp == "source":
        from seigen_jax.solver.imaging import source_illumination
        illum = source_illumination(p0, st0, dt, n_steps, shots, damp=damp)
        raw = raw / (illum + 0.01 * illum.max())

    # post-processing: mute acquisition imprint, remove the smooth
    # backscatter, normalize for stacking/plotting
    acq = np.concatenate([np.asarray(shot_pos), np.asarray(rcv_pts)])
    mute = acquisition_mute(cent, acq, args.mute_radius)
    img = normalize(raw * mute)
    filt = normalize(
        np.asarray(laplacian_filter(p0, jnp.asarray(raw * mute),
                                    args.filter_iters)) * mute)

    # localization metric: |image|-weighted mean depth vs the truth,
    # evaluated away from the sponges (the interior imaging window)
    win = np.ones(E, bool)
    for ax in range(dim - 1):
        win &= (cent[:, ax] > 0.2) & (cent[:, ax] < 0.8)
    win &= cent[:, depth_ax] > 0.18  # above the bottom sponge
    w = np.abs(filt) * win
    z = cent[:, depth_ax]
    z_hat = float((w * z).sum() / w.sum())
    z_rms = float(np.sqrt((w * (z - z_hat) ** 2).sum() / w.sum()))
    # focus metric: fraction of windowed |image| within half a wavelength
    # (+ an element) of the true horizon — the image of a step is a
    # band-limited pulse, so lobe positions are phase-dependent but the
    # pulse ENERGY should concentrate in this band
    band = vmax / f0 / 2 + h
    focus = float(w[np.abs(z - zr) <= band].sum() / w.sum())
    summary = {
        "mode": "rtm", "dim": dim, "E": E, "n_steps": n_steps,
        "shots": args.shots,
        "f0": f0, "vmax": vmax, "h": h, "areal": bool(args.areal),
        "illum_comp": args.illum_comp,
        "misfit": misfit, "z_reflector": zr, "z_imaged": z_hat,
        "z_error": abs(z_hat - zr), "z_rms_spread": z_rms,
        "focus_band": band, "focus": focus,
        "wall_s": time.perf_counter() - t0_wall,
    }
    print(json.dumps(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    if args.out:
        np.savez_compressed(
            args.out, image=img, filtered=filt, mute=mute,
            true_field=true_f[field], bg_field=bg[field],
            field=field, centroids=cent,
            z_reflector=zr)
        print(f"image -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
