"""End-to-end CLI tests (the reference's problem scripts are its user
interface; these run them exactly as a user would)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")


def run_cli(args, timeout=300):
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=ENV,
        capture_output=True, text=True, timeout=timeout,
    )


def test_eigenmode2d_cli(tmp_path):
    out = str(tmp_path / "eig.json")
    r = run_cli(["scripts/eigenmode2d.py", "--degree", "2",
                 "--sizes", "4,8", "--f64", "--cpu",
                 "--min-order", "2.5", "--json", out])
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.load(open(out))
    assert data["observed_order"] > 2.5


def test_explosive_source_cli_sharded(tmp_path):
    """--shards path end-to-end on fake devices (config 5 CLI surface)."""
    out = str(tmp_path / "seis.npz")
    r = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "8",
                 "--degree", "1", "--T", "0.1", "--cpu", "--shards", "4",
                 "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    z = np.load(out)
    assert np.all(np.isfinite(z["seismograms"]))


def test_explosive_source_cli_sharded_vs_one_device(tmp_path):
    """--shards runs the general ppermute DD path; its seismograms match
    the one-device run."""
    out_1 = str(tmp_path / "one.npz")
    out_g = str(tmp_path / "gen.npz")
    common = ["scripts/explosive_source.py", "--dim", "2", "--n", "8",
              "--degree", "1", "--T", "0.1", "--cpu"]
    r1 = run_cli(common + ["--impl", "einsum", "--out", out_1])
    assert r1.returncode == 0, r1.stdout + r1.stderr
    rg = run_cli(common + ["--shards", "4", "--out", out_g])
    assert rg.returncode == 0, rg.stdout + rg.stderr
    assert "sharded path: general" in rg.stdout, rg.stdout
    np.testing.assert_allclose(
        np.load(out_g)["seismograms"], np.load(out_1)["seismograms"],
        rtol=2e-4, atol=1e-7)


def test_explosive_source_cli_gmsh_mesh(tmp_path):
    """--mesh with named physical groups drives BCs end-to-end (the
    reference's production runs: Gmsh mesh + physical-surface BCs)."""
    from seigen_jax.mesh import rect_mesh
    from test_gmsh import _boundary_edges, _write_msh_v2

    topo = rect_mesh(10, 5, lx=2.0, ly=1.0)
    edges = _boundary_edges(topo)
    on_top = np.all(np.abs(topo.vertices[edges][:, :, 1] - 1.0) < 1e-12,
                    axis=1)
    path = str(tmp_path / "m.msh")
    _write_msh_v2(path, topo, groups=[("surface", 1, edges[on_top]),
                                      ("sides", 2, edges[~on_top])])
    out = str(tmp_path / "seis.npz")
    r = run_cli(["scripts/explosive_source.py", "--mesh", path,
                 "--degree", "1", "--T", "0.1", "--cpu",
                 "--bc-free", "surface", "--bc-absorb", "sides",
                 "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    z = np.load(out)
    assert np.all(np.isfinite(z["seismograms"]))


def test_explosive_source_cli_xla_roll_impl(tmp_path):
    """--impl xla_roll (the roll exchange) through the CLI matches the
    einsum path's seismograms."""
    out_r = str(tmp_path / "r.npz")
    out_e = str(tmp_path / "e.npz")
    common = ["scripts/explosive_source.py", "--dim", "2", "--n", "4",
              "--degree", "1", "--T", "0.1", "--cpu"]
    rr = run_cli(common + ["--impl", "xla_roll", "--out", out_r])
    assert rr.returncode == 0, rr.stdout + rr.stderr
    assert "impl: xla_roll" in rr.stdout
    re_ = run_cli(common + ["--impl", "einsum", "--out", out_e])
    assert re_.returncode == 0, re_.stdout + re_.stderr
    np.testing.assert_allclose(
        np.load(out_r)["seismograms"], np.load(out_e)["seismograms"],
        rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("extra,message", [
    (["--impl", "triton"], "needs a GPU"),
    (["--dim", "3", "--n", "2", "--vti", "0.1,0.05,0.1", "--shards", "2"],
     "--vti with --shards is not supported"),
    (["--shards", "2", "--impl", "xla_roll"], "one-device"),
])
def test_explosive_source_cli_refusals(extra, message):
    """Engines and combinations this build does not run exit non-zero
    with a message, instead of running something else."""
    r = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "4",
                 "--degree", "1", "--T", "0.05", "--cpu"] + extra)
    assert r.returncode != 0
    assert message in r.stdout + r.stderr, r.stdout + r.stderr


def test_explosive_source_cli_viscoelastic(tmp_path):
    """--qp/--qs viscoelastic attenuation through the CLI: runs, finite,
    and decays faster than the elastic run."""
    out_v = str(tmp_path / "v.npz")
    out_e = str(tmp_path / "e.npz")
    common = ["scripts/explosive_source.py", "--dim", "2", "--n", "8",
              "--degree", "1", "--T", "0.6", "--cpu",
              "--scheme", "upwind-rk4"]
    rv = run_cli(common + ["--qs", "15", "--qp", "15", "--out", out_v])
    assert rv.returncode == 0, rv.stdout + rv.stderr
    assert "viscoelastic" in rv.stdout
    re_ = run_cli(common + ["--out", out_e])
    assert re_.returncode == 0, re_.stdout + re_.stderr
    sv = np.load(out_v)["seismograms"]
    se = np.load(out_e)["seismograms"]
    assert np.all(np.isfinite(sv))
    # attenuated late-time coda is weaker than elastic
    n = len(sv) // 2
    assert np.abs(sv[n:]).max() < np.abs(se[n:]).max()


def test_explosive_source_cli_vti(tmp_path):
    """--vti Thomsen anisotropy end-to-end: runs stable/finite through
    the aniso einsum path (operator-level physics is verified in
    tests/test_anisotropic.py)."""
    out_a = str(tmp_path / "a.npz")
    r = run_cli(["scripts/explosive_source.py", "--dim", "3", "--n", "4",
                 "--degree", "1", "--T", "0.25", "--cpu",
                 "--vti", "0.25,0.1,0.3", "--out", out_a])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "VTI:" in r.stdout
    sa = np.load(out_a)["seismograms"]
    assert np.all(np.isfinite(sa)) and np.abs(sa).max() > 1e-12


def test_explosive_source_cli_visco_resume(tmp_path):
    """Viscoelastic checkpoint/resume: memory variables ride the
    checkpoint (extras), so the resumed run matches the uninterrupted one
    exactly."""
    ck = str(tmp_path / "ck")
    out1 = str(tmp_path / "full.npz")
    out2 = str(tmp_path / "res.npz")
    common = ["scripts/explosive_source.py", "--dim", "2", "--n", "6",
              "--degree", "1", "--cpu", "--scheme", "upwind-rk4",
              "--qs", "20", "--qp", "20"]
    r = run_cli(common + ["--T", "0.4", "--out", out1])
    assert r.returncode == 0, r.stdout + r.stderr
    r = run_cli(common + ["--T", "0.2", "--checkpoint", ck])
    assert r.returncode == 0, r.stdout + r.stderr
    r = run_cli(common + ["--T", "0.4", "--resume", ck + ".npz",
                          "--out", out2])
    assert r.returncode == 0, r.stdout + r.stderr
    a = np.load(out1)["seismograms"]
    b = np.load(out2)["seismograms"]
    # full and resumed runs compile DIFFERENT scan lengths; XLA may fuse
    # the f32 source scatter-add differently per program, so allow a few
    # ULP
    np.testing.assert_allclose(a[-len(b):], b, rtol=0,
                               atol=1e-6 * np.abs(a).max())


def test_fwi_cli(tmp_path):
    """FWI demo end-to-end: misfit decreases, model artifact written."""
    out = str(tmp_path / "fwi.npz")
    r = run_cli(["scripts/fwi.py", "--n", "8", "--degree", "1",
                 "--iters", "6", "--shots", "2", "--T", "1.0", "--cpu",
                 "--out", out], timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(
        [ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1])
    assert summary["misfit_last"] < summary["misfit_first"] \
        or summary["model_err_reduction"] < 1.0
    z = np.load(out)
    assert np.all(np.isfinite(z["vp_final"]))


def test_explosive_source_cli_resume(tmp_path):
    ck = str(tmp_path / "ck.npz")
    r1 = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "8",
                  "--degree", "1", "--T", "0.05", "--cpu",
                  "--checkpoint", ck])
    assert r1.returncode == 0, r1.stdout + r1.stderr
    r2 = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "8",
                  "--degree", "1", "--T", "0.1", "--cpu",
                  "--resume", ck])
    assert r2.returncode == 0, r2.stdout + r2.stderr


def test_fwi_cli_est_source(tmp_path):
    """--est-source and --precond illum need the custom-VJP gradient
    engine, which this version does not have: both exit with a message
    before any work."""
    for flag in (["--est-source"], ["--precond", "illum"]):
        r = run_cli(["scripts/fwi.py", "--n", "8", "--degree", "1",
                     "--iters", "2", "--shots", "2", "--T", "0.5",
                     "--cpu"] + flag)
        assert r.returncode != 0
        assert "not ported" in r.stdout + r.stderr, r.stdout + r.stderr


def test_fwi_cli_invert_q(tmp_path):
    """--invert-q: attenuation FWI descends and improves the Q model."""
    out = str(tmp_path / "q.npz")
    r = run_cli(["scripts/fwi.py", "--n", "8", "--degree", "1",
                 "--iters", "6", "--shots", "2", "--T", "0.8", "--cpu",
                 "--invert-q", "--out", out], timeout=1200)
    assert r.returncode == 0, r.stdout + r.stderr
    summary = json.loads(
        [ln for ln in r.stdout.splitlines() if ln.startswith("{")][-1])
    assert summary["misfit_last"] < summary["misfit_first"]
    assert summary["qinv_err_reduction"] < 1.0
    z = np.load(out)
    assert np.all(np.isfinite(z["qinv_final"]))


def test_explosive_source_cli_visco_gmsh(tmp_path):
    """Viscoelastic upwind-RK4 on a Gmsh (unstructured) mesh: auto runs
    the XLA Godunov path, whose seismograms equal an explicit --impl
    einsum run's — the physics x mesh-type matrix cell."""
    from seigen_jax.mesh import rect_mesh
    from test_gmsh import _boundary_edges, _write_msh_v2

    rng = np.random.default_rng(5)
    topo = rect_mesh(8, 4, lx=2.0, ly=1.0)
    import dataclasses as _dc
    # jitter INTERIOR vertices so structure recovery cannot re-grid it
    # (a genuinely unstructured conforming mesh, boundary intact)
    v = topo.vertices.copy()
    interior = ((v[:, 0] > 1e-9) & (v[:, 0] < 2.0 - 1e-9)
                & (v[:, 1] > 1e-9) & (v[:, 1] < 1.0 - 1e-9))
    v[interior] += 0.04 * rng.uniform(-1, 1, (interior.sum(), 2))
    topo = _dc.replace(
        topo, vertices=v,
        cells=topo.cells[rng.permutation(topo.num_cells)],
        structure=None)
    edges = _boundary_edges(topo)
    on_top = np.all(np.abs(topo.vertices[edges][:, :, 1] - 1.0) < 1e-12,
                    axis=1)
    path = str(tmp_path / "m.msh")
    _write_msh_v2(path, topo, groups=[("surface", 1, edges[on_top]),
                                      ("sides", 2, edges[~on_top])])
    out_u = str(tmp_path / "u.npz")
    out_e = str(tmp_path / "e.npz")
    common = ["scripts/explosive_source.py", "--mesh", path,
              "--degree", "1", "--T", "0.15", "--cpu",
              "--bc-free", "surface", "--bc-absorb", "sides",
              "--scheme", "upwind-rk4", "--qs", "20", "--qp", "20"]
    ru = run_cli(common + ["--out", out_u])
    assert ru.returncode == 0, ru.stdout + ru.stderr
    assert "impl: upwind" in ru.stdout
    re_ = run_cli(common + ["--impl", "einsum", "--out", out_e])
    assert re_.returncode == 0, re_.stdout + re_.stderr
    np.testing.assert_allclose(
        np.load(out_u)["seismograms"], np.load(out_e)["seismograms"],
        rtol=2e-4, atol=1e-7)


def test_topography_cli(tmp_path):
    """Curvilinear free-surface demo end-to-end: curved VTU geometry,
    receivers riding the topography, finite seismograms."""
    out = str(tmp_path / "topo.npz")
    vtk = str(tmp_path / "topo.pvd")
    r = run_cli(["scripts/topography.py", "--nx", "10", "--nz", "6",
                 "--degree", "1", "--T", "0.15", "--cpu", "--amp", "0.08",
                 "--out", out, "--vtk", vtk, "--vtk-every", "1000"])
    assert r.returncode == 0, r.stdout + r.stderr
    d = np.load(out)
    assert np.isfinite(d["seis"]).all()
    # receivers sit ON the curved surface: the central hill lifts them
    assert d["receivers_phys"][:, 1].max() > 1.01
    vtu = open(str(tmp_path / "topo_00000.vtu")).read()
    assert "UnstructuredGrid" in vtu


def test_explosive_source_cli_pml(tmp_path):
    """--pml C-PML branch end-to-end: runs, stays finite, writes seis."""
    out = str(tmp_path / "seis_pml.npz")
    r = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "8",
                 "--degree", "2", "--T", "0.2", "--pml", "0.25", "--cpu",
                 "--out", out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "impl: cpml" in r.stdout
    z = np.load(out)
    assert np.all(np.isfinite(z["seismograms"]))
    # combination guards
    r = run_cli(["scripts/explosive_source.py", "--dim", "2", "--n", "4",
                 "--degree", "1", "--T", "0.05", "--pml", "0.2", "--cpu",
                 "--shards", "2"])
    assert r.returncode != 0
