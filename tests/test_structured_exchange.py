"""Structured roll-based trace exchange vs the general gather oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.ops import Material, build_params
from seigen_jax.ops.structured_exchange import (
    detect_structured,
    gather_traces_structured,
)

MAT = Material(rho=1.0, vp=2.0, vs=1.0)


def _general_traces(p, field):
    flat = np.asarray(field).reshape(-1, field.shape[-1])
    return flat[np.asarray(p.nbr)].reshape(
        field.shape[0], p.n_faces * p.n_fp, -1)


CASES = [
    ("box peri", lambda: box_mesh(4, 4, 4, periodic=(0, 1, 2)), 2),
    ("box bounded", lambda: box_mesh(3, 4, 5), 2),
    ("box mixed", lambda: box_mesh(4, 4, 2, periodic=(0,)), 1),
    ("rect peri", lambda: rect_mesh(6, 4, periodic=(0, 1)), 3),
    ("rect bounded", lambda: rect_mesh(4, 6), 2),
]


@pytest.mark.parametrize("name,mk,degree", CASES)
def test_structured_matches_gather(name, mk, degree):
    dm = build_discrete(mk(), degree)
    ex = detect_structured(dm)
    assert ex is not None, f"{name}: structure not detected"
    p = build_params(dm, MAT, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    field = jnp.asarray(
        rng.normal(size=(dm.num_elements, dm.re.n_p, 3)))
    ref = _general_traces(p, field)
    out = np.asarray(gather_traces_structured(ex, field))
    assert np.array_equal(out, ref), name


def test_unstructured_returns_none():
    from seigen_jax.mesh.structured import MeshTopology

    topo = rect_mesh(4, 4)
    topo2 = MeshTopology(
        vertices=topo.vertices, cells=topo.cells, extents=topo.extents,
        periodic=(), structure=None)
    dm = build_discrete(topo2, 2)
    assert detect_structured(dm) is None
