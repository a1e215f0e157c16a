"""Engine selection (ops/select.py), the entry points that must refuse
to run without a GPU, the compile-cache helper, and einsum-AD gradients at
sizes an earlier accelerator-specific guard refused."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.dg_kernel import make_kernel_ops
from seigen_jax.ops.select import (
    XLA_STRUCTURED, choose_impl, make_ops, resolve_impl)
from seigen_jax.solver import (
    PointSource, State, absorbing_bc_fn, build_receivers, build_sources,
    cfl_dt, line, run, sponge_mask)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAT = Material(rho=1.0, vp=2.0, vs=1.0)
F32, F64 = np.float32, np.float64


@pytest.mark.parametrize("platform,structured,kw,expected", [
    ("gpu", True, dict(dim=3, degree=3), "triton"),
    ("gpu", False, dict(dim=3, degree=3), "triton"),
    ("gpu", True, dict(dim=2, degree=1), "triton"),
    ("gpu", True, dict(dim=2, degree=4), "triton"),
    ("gpu", True, dict(dim=3, degree=5), XLA_STRUCTURED),
    ("gpu", False, dict(dim=3, degree=5), "einsum"),
    ("gpu", True, dict(dim=3, degree=3, dtype=F64), XLA_STRUCTURED),
    ("gpu", True, dict(dim=3, degree=3, aniso=True), "einsum"),
    ("gpu", True, dict(dim=3, degree=3, scheme="upwind-rk4"), "upwind"),
    ("gpu", True, dict(dim=3, degree=3, pml=True), "cpml"),
    ("gpu", True, dict(dim=3, degree=3, shards=4), "general"),
    ("cpu", True, dict(dim=3, degree=3), XLA_STRUCTURED),
    ("cpu", False, dict(dim=2, degree=2), "einsum"),
    ("cpu", True, dict(dim=3, degree=3, shards=2), "general"),
])
def test_choose_impl_table(platform, structured, kw, expected):
    """``--impl auto``: the kernel only on a GPU, in f32, P1-P4, for the
    isotropic one-device LF path; XLA everywhere else."""
    assert choose_impl(platform, structured, **kw) == expected


@pytest.mark.parametrize("impl,platform,scramble,match", [
    ("triton", "cpu", False, "needs a GPU"),
    ("xla_roll", "cpu", True, "structured"),
    ("pallas", "cpu", False, "unknown impl"),
    ("lane", "gpu", False, "unknown impl"),
])
def test_resolve_impl_refusals(impl, platform, scramble, match):
    topo = rect_mesh(4, 4)
    if scramble:
        import dataclasses

        topo = dataclasses.replace(
            topo, cells=topo.cells[::-1].copy(), structure=None)
    dm = build_discrete(topo, 1)
    with pytest.raises(ValueError, match=match):
        resolve_impl(impl, platform, dm, np.float32)


@pytest.mark.parametrize("platform,expected", [("cpu", XLA_STRUCTURED),
                                               ("gpu", "triton")])
def test_resolve_impl_auto(platform, expected):
    dm = build_discrete(rect_mesh(4, 4), 2)
    assert resolve_impl("auto", platform, dm, np.float32) == expected


def _explosive_case(dim, degree, dtype=jnp.float32):
    n = 4 if dim == 2 else 2
    extents = ((0.0, 1.0),) * dim
    topo = rect_mesh(n, n) if dim == 2 else box_mesh(n, n, n)
    dm = build_discrete(topo, degree, bc_fn=absorbing_bc_fn(
        extents, free_sides=[(dim - 1, "hi")]))
    h = float(dm.h.min())
    src = build_sources(dm, [PointSource(position=(0.45,) * dim, f0=3.0,
                                         t0=0.1, radius=2 * h)],
                        dtype=dtype, mat=MAT)
    rcv = build_receivers(dm, line((0.23,) * dim, (0.77,) * dim, 3),
                          dtype=dtype)
    damp = jnp.asarray(sponge_mask(dm, [(0, "lo")], width=0.3), dtype)
    p = build_params(dm, MAT, dtype=dtype)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, dim), dtype),
               s=jnp.zeros((E, n_p, p.n_sig), dtype))
    return dm, p, src, rcv, damp, st, cfl_dt(h, 2.0, degree, 0.4)


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("impl", ["xla_roll", "triton"])
@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 1)])
def test_engine_scan_matches_einsum(dim, degree, impl, order):
    """Each operator engine inside the full LF scan (source, receivers,
    sponge) against the einsum path; the kernel is interpreted here."""
    dm, p, src, rcv, damp, st, dt = _explosive_case(dim, degree)
    ops = (make_kernel_ops(interpret=True) if impl == "triton"
           else make_ops(impl, p, dm))

    def scan(vo, so):
        return jax.jit(lambda p, st: run(
            p, st, dt, 8, order=order, src=src, damp=damp, receivers=rcv,
            vel_op=vo, stress_op=so))(p, st)

    fin, seis = scan(*ops)
    fin_r, seis_r = scan(*make_ops("einsum", p))
    scale = float(jnp.abs(seis_r).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(seis), np.asarray(seis_r), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(fin.u), np.asarray(fin_r.u),
                               rtol=0, atol=1e-5 * float(
                                   jnp.abs(fin_r.u).max()))


def test_make_ops_names():
    dm = build_discrete(rect_mesh(4, 4), 1)
    p = build_params(dm, MAT, dtype=jnp.float32)
    for impl in ("einsum", "xla_roll", "triton"):
        vo, so = make_ops(impl, p, dm)
        assert callable(vo) and callable(so)
    with pytest.raises(ValueError):
        make_ops("upwind", p, dm)


@pytest.mark.parametrize("field", ["vp", "rho"])
def test_einsum_ad_gradient_above_old_guard(field):
    """Reverse-mode gradient of the seismogram misfit through the LF4
    scan at E = 34992 > 32768 (a size an earlier accelerator-specific
    guard refused) equals the central finite difference along a random
    direction."""
    from seigen_jax.solver.adjoint import seismogram_misfit, with_material

    dm = build_discrete(box_mesh(18, 18, 18), 1, bc_fn=absorbing_bc_fn(
        ((0.0, 1.0),) * 3, free_sides=[(2, "hi")]))
    E = dm.num_elements
    assert E > 32768
    h = float(dm.h.min())
    p0 = build_params(dm, MAT, dtype=jnp.float64)
    src = build_sources(dm, [PointSource(position=(0.5, 0.5, 0.8), f0=4.0,
                                         t0=0.0, radius=2 * h)],
                        dtype=jnp.float64)
    rcv = build_receivers(dm, line((0.4, 0.5, 0.85), (0.6, 0.5, 0.85), 3),
                          dtype=jnp.float64)
    dt, n = cfl_dt(h, 2.0, 1, 0.4), 3
    st0 = State(u=jnp.zeros((E, 4, 3)), s=jnp.zeros((E, 4, 6)))
    base = {"vp": jnp.full(E, 2.0), "rho": jnp.ones(E)}[field]
    obs = jnp.zeros((n, 3, 3))

    def loss(x):
        return seismogram_misfit(with_material(p0, **{field: x}), st0, dt,
                                 n, src, rcv, obs)

    g = jax.jit(jax.grad(loss))(base)
    d = jnp.asarray(np.random.default_rng(0).standard_normal(E))
    eps = 1e-4
    fd = (jax.jit(loss)(base + eps * d) - jax.jit(loss)(base - eps * d)) / (
        2 * eps)
    ad = float(jnp.vdot(g, d))
    assert abs(ad) > 0
    np.testing.assert_allclose(ad, float(fd), rtol=1e-6)


def _run(args, env_extra=None, cwd=REPO, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("with_env", [True, False])
def test_compile_cache_helper(tmp_path, with_env):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and sets
    nothing (JAX reads the variable itself); without it, the cache goes
    to <repo>/.jax_cache."""
    code = ("import jax; from seigen_jax.utils.cache import "
            "enable_compile_cache as e; d = e(); print(d); "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if with_env else {}
    r = _run(["-c", code], env, drop=() if with_env
             else ("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    want = (str(tmp_path) if with_env
            else os.path.join(REPO, ".jax_cache"))
    assert returned == want and configured == want


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py"],
                                  ["-m", "seigen_jax.bench.kernel_ab"]])
def test_device_entry_points_refuse_cpu(args):
    """Without a GPU these exit non-zero, say so, and print no result
    line: a device metric never falls back to the CPU."""
    r = _run(args)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr + r.stdout
    assert '"ok": true' not in r.stdout
    assert "DOF-updates" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied away from the repository exits non-zero."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path), drop=("PYTHONPATH",))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_bench_json_detail_names_device():
    """The benchmark row names the device and the chosen engine (run here
    at a tiny size on the CPU through the library, not bench.py)."""
    from seigen_jax.bench.throughput import main

    out = main(n=1, degree=1, n_steps=2)
    d = out["detail"]
    assert d["backend"] == "cpu" and d["device_count"] >= 1
    assert d["device_kind"] and d["impl"] == XLA_STRUCTURED
    json.dumps(out)
