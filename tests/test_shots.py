"""Ensemble-of-shots vmap batching (SURVEY §3.2 DP extension)."""

import jax
import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.solver import (
    PointSource,
    State,
    build_receivers,
    build_sources,
    cfl_dt,
    line,
    run,
)
from seigen_jax.solver.adjoint import with_material
from seigen_jax.solver.shots import run_shots, shots_misfit, stack_shots

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _setup():
    dm = build_discrete(rect_mesh(8, 8), 1)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    rcv = build_receivers(dm, line((0.2, 0.9), (0.8, 0.9), 3),
                          dtype=jnp.float64)
    shot_list = [
        build_sources(dm, [PointSource(position=(x, 0.6), f0=3.0)],
                      dtype=jnp.float64)
        for x in (0.3, 0.5, 0.7)
    ]
    return dm, p, dt, st, rcv, shot_list


def test_vmapped_shots_match_loop():
    dm, p, dt, st, rcv, shot_list = _setup()
    shots = stack_shots(shot_list)
    n = 15
    fins, seis = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv)
    )(p, st)
    assert seis.shape[0] == 3
    for i, s in enumerate(shot_list):
        ref, ref_seis = jax.jit(
            lambda p, st, s=s: run(p, st, dt, n, order=4, src=s,
                                   receivers=rcv))(p, st)
        np.testing.assert_allclose(np.asarray(fins.u[i]),
                                   np.asarray(ref.u), rtol=1e-12,
                                   atol=1e-15)
        np.testing.assert_allclose(np.asarray(seis[i]),
                                   np.asarray(ref_seis), rtol=1e-12,
                                   atol=1e-15)


def test_shots_misfit_differentiable():
    dm, p, dt, st, rcv, shot_list = _setup()
    shots = stack_shots(shot_list)
    n = 12
    E = dm.num_elements
    vp_true = jnp.full((E,), 2.05, jnp.float64)
    _, observed = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv)
    )(with_material(p, vp=vp_true), st)

    def loss(vp):
        return shots_misfit(with_material(p, vp=vp), st, dt, n, shots,
                            rcv, observed, segment=4)

    val, g = jax.jit(jax.value_and_grad(loss))(jnp.full((E,), 2.0,
                                                        jnp.float64))
    assert float(val) > 0
    g = np.asarray(g)
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0


def test_sharded_shots_match_unsharded():
    """Shot-axis data parallelism over a device mesh: sharded run equals
    the single-device vmap bitwise-ish (8 virtual devices, 8 shots)."""
    from jax.sharding import Mesh

    from seigen_jax.solver.shots import shard_shots

    dm = build_discrete(rect_mesh(6, 6), 1)
    p = build_params(dm, MAT, dtype=jnp.float64)
    dt = cfl_dt(dm.h.min(), 2.0, 1, 0.4)
    E, n_p = dm.num_elements, dm.re.n_p
    st = State(u=jnp.zeros((E, n_p, 2)), s=jnp.zeros((E, n_p, 3)))
    rcv = build_receivers(dm, line((0.2, 0.9), (0.8, 0.9), 3),
                          dtype=jnp.float64)
    xs = np.linspace(0.25, 0.75, 8)
    shots = stack_shots([
        build_sources(dm, [PointSource(position=(float(x), 0.5), f0=3.0)],
                      dtype=jnp.float64) for x in xs])
    n = 10
    ref_fins, ref_seis = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv)
    )(p, st)

    mesh = Mesh(np.array(jax.devices()[:8]), ("shot",))
    shots_sh = shard_shots(shots, mesh)
    fins, seis = jax.jit(
        lambda p, st, sh: run_shots(p, st, dt, n, sh, receivers=rcv)
    )(p, st, shots_sh)
    assert len(seis.sharding.device_set) == 8  # actually shot-parallel
    np.testing.assert_allclose(np.asarray(seis), np.asarray(ref_seis),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(fins.u), np.asarray(ref_fins.u),
                               rtol=1e-12, atol=1e-15)


def test_stack_shots_pads_mismatched_with_inert_entries():
    """Shots with different source-entry counts are zero-amp padded; the
    padded entries must inject nothing (equal to the unpadded run up to
    XLA fusion-order noise — the K-shape change recompiles the scan)."""
    dm, p, dt, st, rcv, shot_list = _setup()
    two = build_sources(
        dm, [PointSource(position=(0.5, 0.6), f0=3.0),
             PointSource(position=(0.4, 0.5), f0=3.0)],
        dtype=jnp.float64)
    ref, seis_ref = run_shots(p, st, dt, 5, stack_shots([shot_list[0]]),
                              receivers=rcv)
    mixed = stack_shots([shot_list[0], two])
    assert mixed.elems.shape == (2, 2)
    out, seis = run_shots(p, st, dt, 5, mixed, receivers=rcv)
    np.testing.assert_allclose(np.asarray(seis[0]),
                               np.asarray(seis_ref[0]),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(out.u[0]),
                               np.asarray(ref.u[0]),
                               rtol=1e-12, atol=1e-15)


def test_lax_map_batching_matches_vmap():
    """batch='map' (one-shot-body lax.map) matches vmap.

    Not bitwise: vmap batches the whole program so XLA fuses/reassociates
    differently than the single-shot body lax.map compiles (measured
    ~4e-14 relative) — same numerics, different instruction schedule.
    """
    dm, p, dt, st, rcv, shot_list = _setup()
    shots = stack_shots(shot_list)
    n = 12
    f_v, s_v = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv,
                                batch="vmap"))(p, st)
    f_m, s_m = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv,
                                batch="map"))(p, st)
    np.testing.assert_allclose(np.asarray(s_v), np.asarray(s_m),
                               rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(np.asarray(f_v.u), np.asarray(f_m.u),
                               rtol=1e-12, atol=1e-18)


def test_host_batching_matches_vmap():
    """batch='host' (per-shot jit + host loop: one shot's program on the
    device at a time) matches vmap."""
    dm, p, dt, st, rcv, shot_list = _setup()
    shots = stack_shots(shot_list)
    n = 12
    f_v, s_v = jax.jit(
        lambda p, st: run_shots(p, st, dt, n, shots, receivers=rcv,
                                batch="vmap"))(p, st)
    f_h, s_h = run_shots(p, st, dt, n, shots, receivers=rcv, batch="host")
    np.testing.assert_allclose(np.asarray(s_v), np.asarray(s_h),
                               rtol=1e-12, atol=1e-18)
    np.testing.assert_allclose(np.asarray(f_v.u), np.asarray(f_h.u),
                               rtol=1e-12, atol=1e-18)


def test_invert_host_batch_matches_vmap():
    """invert(batch='host') accumulates per-shot gradients to the same
    trajectory as the vmapped loss (adam, 3 iterations)."""
    from seigen_jax.solver.fwi import invert

    dm, p, dt, st, rcv, shot_list = _setup()
    shots = stack_shots(shot_list)
    n = 12
    cent = np.asarray(dm.coords.mean(axis=1))
    anom = -0.2 * np.exp(-np.sum((cent - 0.5) ** 2, axis=1) / 0.05)
    p_true = with_material(p, vp=jnp.asarray(2.0 + anom))
    _, obs = jax.jit(
        lambda pp: run_shots(pp, st, dt, n, shots, receivers=rcv))(p_true)

    kw = dict(fields=("vp",), optimizer="adam", lr=0.02, iters=3,
              smooth_iters=1)
    r_v = invert(p, st, dt, n, shots, rcv, obs, batch="vmap", **kw)
    r_h = invert(p, st, dt, n, shots, rcv, obs, batch="host", **kw)
    np.testing.assert_allclose(r_h.misfits, r_v.misfits, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(r_h.theta["vp"]),
                               np.asarray(r_v.theta["vp"]), rtol=1e-9)
