"""Production FWI loop (solver/fwi.py): optimizers, smoothing, bands.

Tiny 2D problems; the assertion is directional (misfit and model error
decrease) plus unit-level checks of the filter and smoother.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PointSource,
    State,
    absorbing_bc_fn,
    build_receivers,
    build_sources,
    cfl_dt,
    line,
    sponge_mask,
)
from seigen_jax.solver.adjoint import with_material
from seigen_jax.solver.fwi import (
    invert,
    lowpass,
    lowpass_taps,
    make_smoother,
)
from seigen_jax.solver.shots import run_shots, stack_shots


def test_lowpass_attenuates_high_passes_low():
    dt = 0.01
    t = np.arange(400) * dt
    lo = np.sin(2 * np.pi * 2.0 * t)
    hi = np.sin(2 * np.pi * 30.0 * t)
    x = jnp.asarray((lo + hi)[None, :, None, None])  # (S, T, R, C)
    taps = lowpass_taps(dt, 5.0, dtype=jnp.float64)
    y = np.asarray(lowpass(x, taps, axis=1))[0, :, 0, 0]
    mid = slice(50, 350)  # away from the zero-padded edges
    # the 30 Hz component must be crushed (>100x), the 2 Hz one kept to
    # within the Gaussian's own ~10% passband droop at 2/5 of cutoff
    proj_hi = abs(np.dot(y[mid], hi[mid]) / np.dot(hi[mid], hi[mid]))
    proj_lo = abs(np.dot(y[mid], lo[mid]) / np.dot(lo[mid], lo[mid]))
    assert proj_hi < 0.01
    assert 0.85 < proj_lo <= 1.0


def test_smoother_preserves_constants_and_smooths():
    dm = build_discrete(rect_mesh(8, 8), 1)
    p = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0),
                     dtype=jnp.float64)
    sm = make_smoother(p, iters=3, weight=0.5)
    E = dm.num_elements
    const = jnp.full((E,), 3.7, jnp.float64)
    np.testing.assert_allclose(np.asarray(sm(const)), 3.7, rtol=1e-12)
    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.standard_normal(E))
    out = np.asarray(sm(noisy))
    assert out.std() < 0.6 * np.asarray(noisy).std()


def _fwi_case(dtype=jnp.float64):
    extents = ((0.0, 1.0), (0.0, 1.0))
    dm = build_discrete(
        rect_mesh(10, 10), 1,
        bc_fn=absorbing_bc_fn(extents, free_sides=[(1, "hi")]))
    p0 = build_params(dm, Material(rho=1.0, vp=2.0, vs=1.0), dtype=dtype)
    E, n_p = dm.num_elements, dm.re.n_p
    h = float(dm.h.min())
    cent = np.asarray(dm.coords.mean(axis=1))
    # shallow anomaly: inside the reflection/transmission coverage of the
    # surface acquisition, so a 12-iteration run has real sensitivity
    anom = -0.25 * np.exp(
        -(((cent[:, 0] - 0.5) ** 2 + (cent[:, 1] - 0.7) ** 2)
          / (2 * 0.12**2)))
    vp_true = jnp.asarray(2.0 + anom, dtype)
    dt = cfl_dt(h, 2.0, 1, 0.4)
    n_steps = 60
    f0 = 0.15 * 2.0 / h / 2
    shots = stack_shots([
        build_sources(dm, [PointSource(position=(float(x), 0.85), f0=f0,
                                       radius=2 * h)], dtype=dtype)
        for x in (0.3, 0.7)])
    rcv = build_receivers(dm, line((0.15, 0.9), (0.85, 0.9), 6),
                          dtype=dtype)
    damp = jnp.asarray(
        sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")], width=0.15),
        dtype)
    st0 = State(u=jnp.zeros((E, n_p, 2), dtype),
                s=jnp.zeros((E, n_p, 3), dtype))
    p_true = with_material(p0, vp=vp_true)
    _, observed = jax.jit(
        lambda p: run_shots(p, st0, dt, n_steps, shots, receivers=rcv,
                            damp=damp))(p_true)
    return p0, st0, dt, n_steps, shots, rcv, observed, vp_true, damp, f0


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_invert_reduces_misfit_and_model_error(optimizer):
    (p0, st0, dt, n_steps, shots, rcv, observed, vp_true, damp,
     f0) = _fwi_case()
    res = invert(
        p0, st0, dt, n_steps, shots, rcv, observed,
        fields=("vp",), optimizer=optimizer, lr=0.005,
        iters=12 if optimizer == "adam" else 10,
        smooth_iters=1, bounds={"vp": (1.5, 2.5)}, damp=damp)
    assert res.misfits[-1] < 0.5 * res.misfits[0]
    # model error in the anomaly region (where the data has sensitivity;
    # a 12-iteration run cannot be asked to also clean far-field drift)
    vp0 = jnp.sqrt((p0.lam + 2 * p0.mu) * p0.inv_rho)
    region = np.abs(np.asarray(vp_true) - 2.0) > 0.05
    err0 = float(jnp.abs(vp0 - vp_true)[region].mean())
    err = float(jnp.abs(res.theta["vp"] - vp_true)[region].mean())
    assert err < 0.9 * err0


def test_invert_frequency_continuation_runs():
    (p0, st0, dt, n_steps, shots, rcv, observed, vp_true, damp,
     f0) = _fwi_case()
    res = invert(
        p0, st0, dt, n_steps, shots, rcv, observed,
        fields=("vp",), optimizer="adam", lr=0.02, iters=3,
        bands=(0.5 * f0, None), smooth_iters=1,
        bounds={"vp": (1.5, 2.5)}, damp=damp)
    assert len(res.bands) == 2
    assert len(res.misfits) == 6
    # misfit values across bands are different objectives (filtered vs
    # full energy) — assert descent WITHIN each band's own trajectory
    assert res.misfits[2] < res.misfits[0]
    assert res.misfits[5] < res.misfits[3]


def test_invert_checkpoint_resume_bitwise(tmp_path):
    """Interrupting an inversion and resuming from the checkpoint
    reproduces the uninterrupted run bitwise — theta, misfit history and
    band log — both mid-band and at a band boundary.

    Interruption is emulated by running a truncated schedule with
    checkpointing (adam is schedule-free, so the optimizer state after k
    iterations of band 0 is identical whether the schedule planned 2 or
    3 iterations)."""
    (p0, st0, dt, n_steps, shots, rcv, observed, vp_true, damp,
     f0) = _fwi_case()
    kw = dict(fields=("vp",), optimizer="adam", lr=0.02, iters=3,
              bands=(0.5 * f0, None), smooth_iters=1,
              bounds={"vp": (1.5, 2.5)}, damp=damp)

    ref = invert(p0, st0, dt, n_steps, shots, rcv, observed, **kw)

    # (a) mid-band kill: 2 of band 0's 3 iterations done
    cka = str(tmp_path / "cut_midband")
    invert(p0, st0, dt, n_steps, shots, rcv, observed,
           **{**kw, "iters": 2, "bands": (0.5 * f0,)},
           checkpoint_path=cka)
    # (b) band-boundary kill: band 0 complete, band 1 not started
    ckb = str(tmp_path / "cut_boundary")
    invert(p0, st0, dt, n_steps, shots, rcv, observed,
           **{**kw, "bands": (0.5 * f0,)},
           checkpoint_path=ckb)

    for ck in (cka, ckb):
        res = invert(p0, st0, dt, n_steps, shots, rcv, observed, **kw,
                     checkpoint_path=ck, resume=True)
        np.testing.assert_array_equal(np.asarray(res.theta["vp"]),
                                      np.asarray(ref.theta["vp"]),
                                      err_msg=ck)
        assert res.misfits == ref.misfits, ck
        assert res.bands == ref.bands, ck
