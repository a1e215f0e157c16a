"""Tests for IO/checkpoint/profiling utilities."""

import os

import jax.numpy as jnp
import numpy as np

from seigen_jax.mesh import build_discrete, rect_mesh
from seigen_jax.solver import State
from seigen_jax.utils import (
    PVDWriter,
    RegionTimer,
    load_checkpoint,
    save_checkpoint,
    write_vtu,
)


def test_checkpoint_roundtrip(tmp_path):
    E, n_p = 10, 6
    st = State(
        u=jnp.asarray(np.random.default_rng(0).normal(size=(E, n_p, 2))),
        s=jnp.asarray(np.random.default_rng(1).normal(size=(E, n_p, 3))),
    )
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, st, 42, {"dt": 0.1})
    st2, step, meta = load_checkpoint(path)
    assert step == 42
    assert meta["dt"] == 0.1
    assert np.array_equal(np.asarray(st.u), np.asarray(st2.u))
    assert np.array_equal(np.asarray(st.s), np.asarray(st2.s))


def test_vtu_and_pvd(tmp_path):
    dm = build_discrete(rect_mesh(3, 3), 2)
    u = np.random.default_rng(0).normal(size=(dm.num_elements, dm.re.n_p, 2))
    path = str(tmp_path / "snap.vtu")
    write_vtu(path, dm, {"u": u})
    text = open(path).read()
    assert "UnstructuredGrid" in text and 'Name="u"' in text

    pvd = PVDWriter(str(tmp_path / "series.pvd"), dm)
    pvd.write(0.0, {"u": u})
    pvd.write(0.5, {"u": u * 2})
    assert len(pvd.entries) == 2
    assert 'timestep="0.5"' in open(str(tmp_path / "series.pvd")).read()


def test_region_timer():
    t = RegionTimer()
    with t.region("a"):
        pass
    with t.region("a"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2
