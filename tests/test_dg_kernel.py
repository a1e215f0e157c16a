"""The fused Pallas/Triton operator kernel (ops/dg_kernel.py) against the
einsum oracle (ops/elastic.py), in interpret mode on the CPU.

On the card the kernel is compiled by Triton; here ``interpret=True``
runs the same kernel body through the Pallas interpreter, so every
index, mask and padding decision is checked.  The grid covers dims 2-3,
P1-P4, both operators, structured and scrambled element order, and every
boundary-condition kind; the edge cases cover blocks that do not divide
E, blocks larger than E, and the padding of n_p and n_fp to powers of
two.  The compiled kernel is checked against the oracle on the card by
``chip_smoke.py`` (phase 2) and by the ``gpu``-marked test below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seigen_jax.mesh import box_mesh, build_discrete, rect_mesh
from seigen_jax.mesh.discrete import BC_ABSORB, BC_FREE, BC_RIGID
from seigen_jax.ops import Material, apply_stress_op, apply_vel_op, build_params
from seigen_jax.ops.dg_kernel import DEGREES, _pow2, make_kernel_ops

BCS = {"free": BC_FREE, "absorb": BC_ABSORB, "rigid": BC_RIGID}
# f32 kernel vs f32 oracle: the two sum in different orders
RTOL = 2e-6


def _params(dim, degree, scramble, bc, seed=0):
    topo = rect_mesh(3, 2) if dim == 2 else box_mesh(1, 1, 2)
    if scramble:
        rng = np.random.default_rng(seed)
        topo = dataclasses.replace(
            topo, cells=topo.cells[rng.permutation(topo.num_cells)],
            structure=None)
    dm = build_discrete(
        topo, degree,
        bc_fn=lambda c, n: np.full(len(c), BCS[bc], dtype=np.int8))
    E = dm.num_elements
    rng = np.random.default_rng(seed + 1)
    mat = Material(rho=1.0 + rng.random(E), vp=2.0 + rng.random(E),
                   vs=0.8 + 0.3 * rng.random(E))
    return build_params(dm, mat, dtype=jnp.float32)


def _field(p, c, seed=2):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((p.Ginv.shape[0], p.n_p, c)),
                       jnp.float32)


def _check(p, op, block=16):
    vel_k, stress_k = make_kernel_ops(block=block, interpret=True)
    if op == "vel":
        x = _field(p, p.n_sig)
        got, ref = vel_k(p, x), apply_vel_op(p, x)
    else:
        x = _field(p, p.dim)
        got, ref = stress_k(p, x), apply_stress_op(p, x)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = float(jnp.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=RTOL * scale)


@pytest.mark.parametrize("bc", sorted(BCS))
@pytest.mark.parametrize("mesh", ["structured", "scrambled"])
@pytest.mark.parametrize("op", ["vel", "stress"])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("dim", [2, 3])
def test_kernel_matches_oracle(dim, degree, op, mesh, bc):
    _check(_params(dim, degree, mesh == "scrambled", bc), op)


@pytest.mark.parametrize("dim,degree,block", [
    (2, 2, 16),   # E = 12 < block: one partial program
    (2, 1, 32),   # E = 12, block 32
    (3, 2, 16),   # E = 12
    (3, 3, 64),   # block far above E
])
def test_kernel_block_larger_than_mesh(dim, degree, block):
    _check(_params(dim, degree, False, "free"), "vel", block=block)
    _check(_params(dim, degree, False, "free"), "stress", block=block)


@pytest.mark.parametrize("block", [16, 32])
def test_kernel_partial_last_block(block):
    """E = 6 * 2 * 2 * 3 = 72 is no multiple of 16 or 32: the masked tail
    program must neither read nor write past the end."""
    dm = build_discrete(box_mesh(2, 2, 3), 2)
    p = build_params(dm, Material(1.0, 2.0, 1.0), dtype=jnp.float32)
    assert p.Ginv.shape[0] % block
    _check(p, "vel", block=block)
    _check(p, "stress", block=block)


@pytest.mark.parametrize("n,expected", [(1, 16), (3, 16), (16, 16),
                                        (17, 32), (20, 32), (35, 64)])
def test_pad_to_power_of_two(n, expected):
    """Node axes pad to powers of two of at least 16 (Triton's dot)."""
    assert _pow2(n) == expected


def test_kernel_refuses_sharded_pool():
    """The kernel gathers from the local field only: a ghost pool (the DD
    path) must go to the XLA operators, not be silently ignored."""
    p = _params(2, 1, False, "free")
    vel_k, stress_k = make_kernel_ops(block=16, interpret=True)
    with pytest.raises(ValueError, match="pool"):
        vel_k(p, _field(p, p.n_sig), pool=jnp.zeros((1, p.n_sig)))
    with pytest.raises(ValueError, match="pool"):
        stress_k(p, _field(p, p.dim), pool=jnp.zeros((1, p.dim)))


def test_kernel_inside_jit_and_scan():
    """The kernel composes with jit and lax.scan (as inside the LF4 step)."""
    p = _params(2, 2, False, "absorb")
    vel_k, stress_k = make_kernel_ops(block=16, interpret=True)
    u = _field(p, p.dim)

    def body(u, _):
        return 0.01 * vel_k(p, stress_k(p, u)) + u, None

    got, _ = jax.jit(lambda u: jax.lax.scan(body, u, None, length=2))(u)
    ref = u
    for _ in range(2):
        ref = 0.01 * apply_vel_op(p, apply_stress_op(p, ref)) + ref
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(jnp.abs(ref).max()))


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skip otherwise (decided
    here, at run time, never while the module is imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "backend (interpret mode is covered above)")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("degree", DEGREES)
def test_kernel_compiled_matches_oracle(gpu, degree):
    """The kernel as Triton compiles it for the card, 3D, vs the oracle."""
    dm = build_discrete(box_mesh(4, 4, 4), degree)
    p = build_params(dm, Material(1.0, 2.0, 1.0), dtype=jnp.float32)
    vel_k, stress_k = make_kernel_ops()
    for k_op, ref_op, c in ((vel_k, apply_vel_op, 6),
                            (stress_k, apply_stress_op, 3)):
        x = _field(p, c)
        got, ref = jax.jit(k_op)(p, x), jax.jit(ref_op)(p, x)
        assert float(jnp.abs(got - ref).max()) <= 1e-5 * float(
            jnp.abs(ref).max())
