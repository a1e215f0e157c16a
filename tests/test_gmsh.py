"""Gmsh importer round-trip tests (write-our-own .msh, read back, solve)."""

import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.mesh.discrete import BC_ABSORB, BC_FREE
from seigen_jax.mesh.gmsh_io import read_msh


def _boundary_edges(topo):
    """(nedges, 2) vertex-id pairs of boundary edges of a 2D mesh."""
    from collections import Counter

    cnt = Counter()
    for c in topo.cells:
        for a, b in ((c[0], c[1]), (c[1], c[2]), (c[2], c[0])):
            cnt[tuple(sorted((int(a), int(b))))] += 1
    return np.array([e for e, n in cnt.items() if n == 1], dtype=np.int64)


def _write_msh_v2(path, topo, groups=None):
    """groups: list of (name, phys_tag, facet array) boundary line groups."""
    groups = groups or []
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        if groups:
            f.write(f"$PhysicalNames\n{len(groups)}\n")
            for name, tag, _ in groups:
                f.write(f'1 {tag} "{name}"\n')
            f.write("$EndPhysicalNames\n")
        f.write(f"$Nodes\n{len(topo.vertices)}\n")
        for k, v in enumerate(topo.vertices):
            z = v[2] if topo.dim == 3 else 0.0
            f.write(f"{k+1} {v[0]} {v[1]} {z}\n")
        f.write("$EndNodes\n")
        etype = 2 if topo.dim == 2 else 4
        n_fac = sum(len(fs) for _, _, fs in groups)
        f.write(f"$Elements\n{len(topo.cells) + n_fac}\n")
        eid = 1
        for _, tag, fs in groups:
            for fac in fs:
                vs = " ".join(str(v + 1) for v in fac)
                f.write(f"{eid} 1 2 {tag} 0 {vs}\n")
                eid += 1
        for c in topo.cells:
            vs = " ".join(str(v + 1) for v in c)
            f.write(f"{eid} {etype} 2 0 0 {vs}\n")
            eid += 1
        f.write("$EndElements\n")


def test_msh_v2_roundtrip(tmp_path):
    topo = rect_mesh(4, 3)
    path = str(tmp_path / "m.msh")
    _write_msh_v2(path, topo)
    topo2 = read_msh(path)
    assert topo2.num_cells == topo.num_cells
    assert np.allclose(np.sort(topo2.vertices, axis=0),
                       np.sort(topo.vertices, axis=0))
    # the imported mesh builds a valid discrete mesh
    dm = build_discrete(topo2, 2)
    assert abs(dm.detJ.sum() / 2 - 1.0) < 1e-12


def test_msh_physical_groups_to_bc(tmp_path):
    """Named physical line groups drive BC codes (SURVEY.md §4.4:
    the reference attaches BCs to Gmsh physical surface ids)."""
    topo = rect_mesh(4, 3)
    edges = _boundary_edges(topo)
    ymax = topo.extents[1][1]
    on_top = np.all(
        np.abs(topo.vertices[edges][:, :, 1] - ymax) < 1e-12, axis=1)
    groups = [("surface", 11, edges[on_top]),
              ("absorbing", 12, edges[~on_top])]
    path = str(tmp_path / "m.msh")
    _write_msh_v2(path, topo, groups=groups)
    topo2 = read_msh(path)
    assert set(topo2.facet_groups) == {"surface", "absorbing"}
    assert len(topo2.facet_groups["surface"]) == int(on_top.sum())

    dm = build_discrete(topo2, 2, bc_groups={"surface": BC_FREE,
                                             "absorbing": BC_ABSORB})
    # every boundary face got the right code: free exactly on y=ymax
    be, bf = np.nonzero(dm.bc)
    assert len(be)  # absorbing faces are coded (BC_FREE == 0 on top)
    import seigen_jax.mesh.discrete as md

    for e, f in zip(*np.nonzero(dm.bc == BC_ABSORB)):
        fv = topo2.vertices[topo2.cells[e, md.ref_elem(2, 2).face_vertices[f]]]
        assert not np.all(np.abs(fv[:, 1] - ymax) < 1e-12)
    # count: boundary faces on top are free, so absorb count matches group
    assert (dm.bc == BC_ABSORB).sum() == int((~on_top).sum())

    # unknown group name is a hard error
    import pytest

    with pytest.raises(ValueError):
        build_discrete(topo2, 2, bc_groups={"nope": BC_FREE})


def test_msh_physical_groups_match_extents_bc(tmp_path):
    """Group-driven BCs reproduce the extents-plane absorbing_bc_fn codes
    on the same mesh (the two BC assignment routes agree)."""
    from seigen_jax.solver import absorbing_bc_fn

    topo = rect_mesh(5, 4)
    edges = _boundary_edges(topo)
    ymax = topo.extents[1][1]
    on_top = np.all(
        np.abs(topo.vertices[edges][:, :, 1] - ymax) < 1e-12, axis=1)
    path = str(tmp_path / "m.msh")
    _write_msh_v2(path, topo, groups=[("surface", 1, edges[on_top]),
                                      ("absorbing", 2, edges[~on_top])])
    topo2 = read_msh(path)
    dm_g = build_discrete(topo2, 1, bc_groups={"surface": BC_FREE,
                                               "absorbing": BC_ABSORB})
    dm_e = build_discrete(
        topo2, 1, bc_fn=absorbing_bc_fn(topo2.extents, [(1, "hi")]))
    np.testing.assert_array_equal(dm_g.bc, dm_e.bc)
