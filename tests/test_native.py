"""Native (C++) mesh kernels vs their NumPy oracles (SURVEY.md §3.1 #3)."""

import numpy as np
import pytest

from seigen_jax.mesh import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++?)"
)


def test_pair_face_nodes_matches_numpy():
    rng = np.random.default_rng(0)
    # synthetic keys: many pairs, some singletons
    base = rng.integers(0, 50, size=(300, 4)).astype(np.int64)
    keys = np.concatenate([base, base, rng.integers(60, 99, size=(37, 4))])
    rng.shuffle(keys)
    partner, mult = native.pair_face_nodes(keys)
    assert mult <= 2 or mult == keys.shape[0]  # duplicates in base possible
    # verify: partner is involutive and keys match
    N = len(keys)
    for i in range(N):
        j = partner[i]
        assert partner[j] == i
        assert np.array_equal(keys[i], keys[j])


def test_pair_on_real_mesh_connectivity():
    """build_discrete with native path equals the pure-NumPy result."""
    from seigen_jax.mesh import box_mesh, build_discrete
    import seigen_jax.mesh.discrete as D

    topo = box_mesh(3, 2, 2, periodic=(0,))
    dm_native = build_discrete(topo, 2)

    # force the NumPy fallback
    orig = native.available
    try:
        native.available = lambda: False
        dm_np = build_discrete(topo, 2)
    finally:
        native.available = orig

    assert np.array_equal(dm_native.nbr, dm_np.nbr)
    assert np.array_equal(dm_native.bc, dm_np.bc)


def test_morton_matches_numpy():
    from seigen_jax.parallel.partition import morton_order

    rng = np.random.default_rng(1)
    pts = rng.uniform(size=(5000, 3))
    p_native = morton_order(pts)
    orig = native.available
    try:
        native.available = lambda: False
        p_np = morton_order(pts)
    finally:
        native.available = orig
    assert np.array_equal(p_native, p_np)


def test_geometric_factors_match_numpy():
    """Native closed-form geometry vs the LAPACK NumPy path: same values
    to rounding (adjugate inverse vs LU differ only in ULPs)."""
    from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh

    for topo in (box_mesh(3, 2, 2), rect_mesh(4, 3)):
        dm_native = build_discrete(topo, 2)
        orig = native.available
        try:
            native.available = lambda: False
            dm_np = build_discrete(topo, 2)
        finally:
            native.available = orig
        for name in ("Ginv", "detJ", "normals", "Fscale", "h"):
            np.testing.assert_allclose(
                getattr(dm_native, name), getattr(dm_np, name),
                rtol=1e-12, atol=1e-14, err_msg=name)


def test_halo_needs_match_numpy():
    """Native sort+dedup needs == the lexsort + np.unique oracle, and the
    full halo plan is identical under either path."""
    rng = np.random.default_rng(3)
    P, n = 5, 4000
    gids = rng.integers(0, 900, size=n).astype(np.int64)
    src = rng.integers(0, P, size=n).astype(np.int32)
    dst = rng.integers(0, P, size=n).astype(np.int32)
    keep = src != dst
    gids, src, dst = gids[keep], src[keep], dst[keep]
    needs = native.halo_needs(gids, src, dst, P)
    # oracle
    ref = {}
    for q in range(P):
        for p_ in range(P):
            sel = (src == q) & (dst == p_)
            if sel.any():
                ref[(q, p_)] = np.unique(gids[sel])
    assert set(needs) == set(ref)
    for k in ref:
        assert np.array_equal(needs[k], ref[k]), k

    # end-to-end: make_plan identical on both paths
    from seigen_jax.mesh import box_mesh, build_discrete
    from seigen_jax.parallel.partition import make_plan

    dm = build_discrete(box_mesh(3, 3, 3), 1)
    plan_native = make_plan(dm, 4)
    orig = native.available
    try:
        native.available = lambda: False
        plan_np = make_plan(dm, 4)
    finally:
        native.available = orig
    assert np.array_equal(plan_native.send_idx, plan_np.send_idx)
    assert np.array_equal(plan_native.nbr_local, plan_np.nbr_local)
    assert plan_native.round_perms == plan_np.round_perms
