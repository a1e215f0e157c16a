"""Additional coverage: 3D explosive smoke, P4 convergence, resume equality,
Gmsh v4.1."""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.mesh.gmsh_io import read_msh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PlaneWave,
    PointSource,
    State,
    absorbing_bc_fn,
    build_receivers,
    build_sources,
    cfl_dt,
    interpolate,
    l2_error,
    line,
    run,
    sponge_mask,
)
from seigen_jax.utils import load_checkpoint, save_checkpoint

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def test_explosive_source_3d_smoke():
    """Config-per-[D] 3D explosive source: runs, stays finite, signal moves."""
    extents = ((0.0, 1.0),) * 3
    topo = box_mesh(6, 6, 6)
    bc_fn = absorbing_bc_fn(extents, free_sides=[(2, "hi")])
    dm = build_discrete(topo, 1, bc_fn=bc_fn)
    p = build_params(dm, MAT, dtype=jnp.float64)
    src = build_sources(
        dm, [PointSource(position=(0.5, 0.5, 0.7), f0=4.0, radius=0.2)],
        dtype=jnp.float64)
    rcv = build_receivers(
        dm, line((0.2, 0.5, 0.9), (0.8, 0.5, 0.9), 4), dtype=jnp.float64)
    damp = jnp.asarray(sponge_mask(
        dm, [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi"), (2, "lo")],
        width=0.25))
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 3)), s=jnp.zeros((E, n_p, 6)))
    fin, seis = jax.jit(
        lambda p, st: run(p, st, dt, 80, order=4, src=src, damp=damp,
                          receivers=rcv))(p, st)
    assert np.all(np.isfinite(np.asarray(fin.u)))
    assert np.abs(np.asarray(seis)).max() > 1e-12


def test_p4_2d_eigenmode():
    """Degree-4 spatial path (tables, ops) converges."""
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 0.0]), mode="S")
    T = 0.25 * pw.period
    errs = []
    for N in [2, 4]:
        dm = build_discrete(rect_mesh(N, N, periodic=(0, 1)), 4)
        p = build_params(dm, MAT, dtype=jnp.float64)
        dt = cfl_dt(dm.h.min(), 2.0, 4, 0.4)
        n_steps = int(np.ceil(T / dt))
        dt = T / n_steps
        st = State(
            u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
            s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
        )
        fin, _ = jax.jit(lambda p, st: run(p, st, dt, n_steps, order=4))(p, st)
        errs.append(l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt))
    assert np.log2(errs[0] / errs[1]) > 3.5, errs


def test_checkpoint_resume_equivalence(tmp_path):
    """Run 20 steps straight == run 10, checkpoint, resume, run 10."""
    dm = build_discrete(rect_mesh(8, 8, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    pw = PlaneWave(mat=MAT, k=2 * np.pi * np.array([1.0, 1.0]), mode="S")
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    st0 = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    full, _ = jax.jit(lambda p, st: run(p, st, dt, 20, order=4))(p, st0)

    half, _ = jax.jit(lambda p, st: run(p, st, dt, 10, order=4))(p, st0)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, half, 10)
    loaded, step, _ = load_checkpoint(path)
    assert step == 10
    resumed, _ = jax.jit(lambda p, st: run(p, st, dt, 10, order=4))(p, loaded)
    assert np.array_equal(np.asarray(resumed.u), np.asarray(full.u))
    assert np.array_equal(np.asarray(resumed.s), np.asarray(full.s))


def test_checkpoint_extensionless_path(tmp_path):
    """save_checkpoint('ck') and load_checkpoint('ck') agree on 'ck.npz'."""
    st = State(u=jnp.ones((2, 3, 2)), s=jnp.zeros((2, 3, 3)))
    path = str(tmp_path / "ck")  # no .npz
    save_checkpoint(path, st, 7)
    loaded, step, _ = load_checkpoint(path)
    assert step == 7
    assert np.array_equal(np.asarray(loaded.u), np.asarray(st.u))


def test_sharded_resume_equivalence():
    """Sharded run with a TIME-DEPENDENT source: 12 straight == 6 + resume 6
    with step0=6 (the Ricker wavelet must stay in phase across the resume)."""
    from seigen_jax.parallel import run_distributed

    extents = ((0.0, 1.0), (0.0, 1.0))
    dm = build_discrete(
        rect_mesh(8, 8),
        2,
        bc_fn=absorbing_bc_fn(extents, free_sides=[(1, "hi")]),
    )
    src = build_sources(
        dm, [PointSource(position=(0.5, 0.7), f0=4.0, radius=0.2)],
        dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st0 = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))

    full, _, _ = run_distributed(
        dm, MAT, st0, dt, 12, n_devices=4, sources=src, dtype=jnp.float64)
    half, _, _ = run_distributed(
        dm, MAT, st0, dt, 6, n_devices=4, sources=src, dtype=jnp.float64)
    resumed, _, _ = run_distributed(
        dm, MAT, half, dt, 6, n_devices=4, sources=src, dtype=jnp.float64,
        step0=6)
    np.testing.assert_allclose(
        np.asarray(resumed.u), np.asarray(full.u), rtol=1e-12, atol=1e-14)
    # regression guard: WITHOUT the offset the wavelet re-injects from t=0
    wrong, _, _ = run_distributed(
        dm, MAT, half, dt, 6, n_devices=4, sources=src, dtype=jnp.float64)
    assert np.abs(np.asarray(wrong.u) - np.asarray(full.u)).max() > 1e-10


def _write_msh_v41(path, topo):
    with open(path, "w") as f:
        f.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
        nv = len(topo.vertices)
        f.write(f"$Nodes\n1 {nv} 1 {nv}\n")
        f.write(f"2 1 0 {nv}\n")
        for k in range(nv):
            f.write(f"{k+1}\n")
        for v in topo.vertices:
            z = v[2] if topo.dim == 3 else 0.0
            f.write(f"{v[0]} {v[1]} {z}\n")
        f.write("$EndNodes\n")
        etype = 2 if topo.dim == 2 else 4
        ne = len(topo.cells)
        f.write(f"$Elements\n1 {ne} 1 {ne}\n")
        f.write(f"2 1 {etype} {ne}\n")
        for k, c in enumerate(topo.cells):
            vs = " ".join(str(v + 1) for v in c)
            f.write(f"{k+1} {vs}\n")
        f.write("$EndElements\n")


def test_msh_v41_roundtrip(tmp_path):
    topo = rect_mesh(3, 4)
    path = str(tmp_path / "m41.msh")
    _write_msh_v41(path, topo)
    topo2 = read_msh(path)
    assert topo2.num_cells == topo.num_cells
    dm = build_discrete(topo2, 2)
    assert abs(dm.detJ.sum() / 2 - 1.0) < 1e-12


def test_moment_tensor_source_double_couple():
    """kind='moment' with a double-couple M radiates the classic 4-lobe
    S-dominant pattern: velocity nodal along the fault axes, maximal at 45
    degrees; also moment=[1,1,0(*)] must equal kind='explosive'."""
    dm = build_discrete(rect_mesh(24, 24, periodic=(0, 1)), 2)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 2, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))

    def run_src(ps):
        s = build_sources(dm, [ps], dtype=jnp.float64)
        fin, _ = jax.jit(
            lambda p, st: run(p, st, dt, 60, order=4, src=s))(p, st)
        return np.asarray(fin.u)

    # equivalence: explosive == isotropic moment
    u_exp = run_src(PointSource(position=(0.5, 0.5), f0=8.0, radius=0.06))
    u_iso = run_src(PointSource(position=(0.5, 0.5), f0=8.0, radius=0.06,
                                kind="moment", moment=(1.0, 1.0, 0.0)))
    assert np.allclose(u_exp, u_iso, atol=1e-14)

    # double couple M = [[0,1],[1,0]] -> Voigt (0, 0, 1)
    u_dc = run_src(PointSource(position=(0.5, 0.5), f0=8.0, radius=0.06,
                               kind="moment", moment=(0.0, 0.0, 1.0)))
    cent = dm.coords.mean(axis=1) - 0.5
    r = np.linalg.norm(cent, axis=1)
    ring = (r > 0.2) & (r < 0.3)
    theta = np.arctan2(cent[:, 1], cent[:, 0])
    amp = np.abs(u_dc).max(axis=(1, 2))
    # P radiation of a double couple ~ |sin 2 theta|: lobes at 45 deg,
    # nodes on the axes
    on_axis = ring & (np.abs(np.sin(2 * theta)) < 0.2)
    on_lobe = ring & (np.abs(np.sin(2 * theta)) > 0.9)
    assert amp[on_lobe].mean() > 2.0 * amp[on_axis].mean(), (
        amp[on_lobe].mean(), amp[on_axis].mean())


def test_many_simultaneous_sources():
    """32-shot simultaneous-source run (FWI-style encoded shooting):
    superposition holds — the multi-source wavefield equals the sum of
    single-source wavefields (linear physics, shared wavelet)."""
    dm = build_discrete(rect_mesh(12, 12, periodic=(0, 1)), 1)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    rng = np.random.default_rng(0)
    positions = 0.1 + 0.8 * rng.uniform(size=(8, 2))
    srcs = [PointSource(position=tuple(q), f0=6.0, radius=0.08,
                        amplitude=float(a))
            for q, a in zip(positions, rng.uniform(0.5, 2.0, size=8))]

    def final(source_list):
        s = build_sources(dm, source_list, dtype=jnp.float64)
        fin, _ = jax.jit(
            lambda p, st: run(p, st, dt, 30, order=4, src=s))(p, st)
        return np.asarray(fin.u)

    u_all = final(srcs)
    u_sum = sum(final([s]) for s in srcs)
    np.testing.assert_allclose(u_all, u_sum, rtol=1e-10, atol=1e-12)


def test_kinematic_rupture_directivity():
    """A unilateral finite-fault rupture (kinematic_rupture) shows forward
    directivity: stations ahead of rupture propagation see larger peak
    amplitudes (Doppler pulse compression) than stations behind."""
    from seigen_jax.solver import kinematic_rupture

    from seigen_jax.solver import absorbing_bc_fn, build_receivers, sponge_mask
    from seigen_jax.solver.timestep import run as run_ts

    extents = ((0.0, 2.0), (0.0, 1.0))
    dm = build_discrete(
        rect_mesh(40, 20, lx=2.0), 1,
        bc_fn=absorbing_bc_fn(extents, free_sides=[]))
    damp = jnp.asarray(sponge_mask(
        dm, [(0, "lo"), (0, "hi"), (1, "lo"), (1, "hi")], width=0.15),
        jnp.float64)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    srcs = kinematic_rupture(
        a=(0.7, 0.5), b=(1.3, 0.5), n_sub=13,
        moment=(1.0, 1.0, 0.0), f0=8.0,
        rupture_velocity=0.8, radius=0.05)
    assert len(srcs) == 13
    t0s = np.array([s.t0 for s in srcs])
    assert np.all(np.diff(t0s) > 0)  # unilateral: delays grow along strike
    s = build_sources(dm, srcs, dtype=jnp.float64)
    rcv = build_receivers(dm, np.array([[1.7, 0.5], [0.3, 0.5]]),
                          dtype=jnp.float64)
    T = float(t0s[-1]) + 0.5 / 2.0 + 0.3  # last onset + travel + tail
    n_steps = int(np.ceil(T / dt))
    _, seis = jax.jit(
        lambda p, st: run_ts(p, st, dt, n_steps, order=4, src=s,
                             damp=damp, receivers=rcv))(p, st)
    seis = np.asarray(seis)  # (n, 2, dim)

    # forward directivity = apparent source-time compression: the signal
    # DURATION ahead of rupture propagation is shorter than behind
    # (arrival spacing dx(1/v_r -+ 1/vp)); peak amplitude of superposed
    # zero-mean wavelets is not a monotone observable, duration is.
    def duration(tr):
        a = np.abs(tr).max(axis=1)
        on = np.where(a > 0.15 * a.max())[0]
        return (on[-1] - on[0]) * dt

    d_fwd, d_bwd = duration(seis[:, 0]), duration(seis[:, 1])
    assert d_fwd < 0.75 * d_bwd, (d_fwd, d_bwd)


def test_acoustic_medium_mu_zero():
    """Acoustic limit (vs=0, marine case): P eigenmode propagates correctly
    through both the central/leapfrog and upwind/RK4 paths."""
    from seigen_jax.ops.upwind import build_upwind_data
    from seigen_jax.solver.rk4 import run_rk4

    mat = Material(rho=1.0, vp=1.5, vs=0.0)
    pw = PlaneWave(mat=mat, k=2 * np.pi * np.array([1.0, 0.0]), mode="P")
    T = 0.5 * pw.period
    dm = build_discrete(rect_mesh(12, 12, periodic=(0, 1)), 2)
    p = build_params(dm, mat, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 1.5, 2, 0.4)
    n_steps = int(np.ceil(T / dt))
    dt = T / n_steps
    st = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.5 * dt)),
    )
    fin, _ = jax.jit(lambda p, st: run(p, st, dt, n_steps, order=4))(p, st)
    err = l2_error(dm, np.asarray(fin.u), pw.u, n_steps * dt)
    assert err < 5e-3, err

    w = build_upwind_data(dm, mat, dtype=jnp.float64)
    st0 = State(
        u=jnp.asarray(interpolate(dm, pw.u, 0.0)),
        s=jnp.asarray(interpolate(dm, pw.sigma, 0.0)),
    )
    fin2, _ = jax.jit(
        lambda p, w, st: run_rk4(p, w, st, dt, n_steps))(p, w, st0)
    err2 = l2_error(dm, np.asarray(fin2.u), pw.u, n_steps * dt)
    assert np.isfinite(err2) and err2 < 5e-3, err2
