"""RTM imaging: the adjoint-state migration localizes a reflector.

The imaging demo (scripts/rtm.py + solver/imaging.py) is beyond-parity
capability (the reference was forward-only, SURVEY.md §2); these tests
pin its physics — an impedance (rho) step imaged from surface data
concentrates image energy at the interface — and the post-processing
utilities on a mesh-agnostic oracle.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ,
           XLA_FLAGS="--xla_force_host_platform_device_count=8")


def run_cli(args, timeout=900):
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=ENV,
        capture_output=True, text=True, timeout=timeout,
    )


def test_rtm_localizes_reflector(tmp_path):
    """Multi-shot einsum-path RTM: |image| concentrates at the horizon."""
    out = str(tmp_path / "rtm.json")
    r = run_cli(["scripts/rtm.py", "--n", "12", "--degree", "2",
                 "--shots", "3", "--receivers", "14", "--f0", "8",
                 "--cpu", "--f64",
                 "--json", out])
    assert r.returncode == 0, r.stdout + r.stderr
    s = json.load(open(out))
    # measured on this config: z_error ~0.04, focus ~0.83 (see script
    # docstring); gates at 2x the measured slack
    assert s["z_error"] < 0.1, s
    assert s["focus"] > 0.6, s
    assert s["z_rms_spread"] < 0.2, s


def test_rtm_3d_areal_localizes_reflector(tmp_path):
    """3D acceptance at CI scale (VERDICT r3 #4): areal acquisition +
    source-illumination compensation localize the horizon to within half
    a wavelength.  Line acquisition + raw cross-correlation CANNOT image
    a 3D volume: measured at this exact config, line/no-illum gives
    z_error 0.332 vs areal/illum 0.253 (bar: vmax/f0/2 = 0.39 — coarse
    because the CI wavelength is huge; the calibrated E=3072 ladder in
    BENCH_NOTES round 4 separates the causes cleanly: 0.205 -> 0.188
    illum -> 0.116 areal at f0=6 where the bar is 0.167)."""
    out = str(tmp_path / "rtm3d.json")
    r = run_cli(["scripts/rtm.py", "--dim", "3", "--n", "6",
                 "--degree", "1", "--shots", "4", "--receivers", "16",
                 "--areal", "--cpu", "--f64",
                 "--json", out], timeout=1800)
    assert r.returncode == 0, r.stdout + r.stderr
    s = json.load(open(out))
    half_wavelength = s["vmax"] / s["f0"] / 2
    assert s["z_error"] < half_wavelength, s
    assert s["focus"] > 0.5, s


def test_imaging_utilities():
    """laplacian_filter kills constants, keeps oscillation; mute ramps."""
    import jax.numpy as jnp

    from seigen_jax.mesh import build_discrete, rect_mesh
    from seigen_jax.ops import Material, build_params
    from seigen_jax.solver.imaging import (
        acquisition_mute, laplacian_filter, normalize)

    dm = build_discrete(rect_mesh(8, 8), 1)
    p = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0),
                     dtype=jnp.float64)
    cent = np.asarray(dm.coords.mean(axis=1))

    # constants are in the nullspace of the graph Laplacian
    g_const = np.full(dm.num_elements, 3.7)
    out = np.asarray(laplacian_filter(p, jnp.asarray(g_const)))
    assert np.abs(out).max() < 1e-12

    # an oscillatory field survives (high-pass, not a smoother)
    g_osc = np.sin(20 * cent[:, 1])
    out = np.asarray(laplacian_filter(p, jnp.asarray(g_osc)))
    assert np.abs(out).max() > 0.1 * np.abs(g_osc).max()

    # mute: zero at the point, ~1 far away, monotone ramp
    k = np.argmin(np.linalg.norm(cent - 0.5, axis=1))
    m = acquisition_mute(cent, [cent[k]], radius=0.3)
    assert m[k] == 0.0
    far = np.linalg.norm(cent - cent[k], axis=1) > 0.45
    assert np.all(m[far] > 0.99)
    d = np.linalg.norm(cent - cent[k], axis=1)
    mid = (d > 0.05) & (d < 0.28)
    assert np.all((m[mid] > 0) & (m[mid] < 1))

    # normalize: unit max-abs, zero-safe
    assert np.abs(normalize(g_osc)).max() == 1.0
    assert np.all(normalize(np.zeros(4)) == 0)
