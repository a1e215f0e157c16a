"""One fused GPU kernel per DG operator application (Pallas, Triton route).

``apply_vel_op`` / ``apply_stress_op`` in ops/elastic.py are several XLA
ops each: the (E, dim, n_p, C) reference gradient, the gathered
(E, nf, nfp, C) own and neighbour traces and the face flux all go through
device memory.  Here one program handles a block of ``block`` elements and
keeps everything in registers: it reads each input field from the cache
(plus the neighbour face nodes through ``p.nbr``), and writes the result
once.

Layout is the XLA path's element-major (E, n_p, C).  The node and
face-node axes are padded to powers of two (Triton's block shapes) by
masked loads; only the small reference tables are padded in memory.  The
kernel streams: inputs are loaded where a product needs them, faces are
taken one at a time with their per-face scalars as (block, 1) columns and
their own LIFT block, so the live tiles stay few (holding all components
and all faces at once spilled registers on the H100; PERF.md).  Both
operators are one template: the physics enters as the trace-time closures
``_VEL`` and ``_STRESS``, built from the same ``traction_comps`` /
``hooke_comps`` as the XLA operators.  All contractions are ``pl.dot`` at
HIGHEST precision (IEEE f32, no TF32).

The ``nbr`` table indexes the flat (E * n_p) node array, so structured and
unstructured meshes take the same kernel.  Sharded pools (``pool=``),
anisotropy and f64 stay on the XLA operators (ops/select.py decides).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .elastic import ElasticParams, hooke_comps, traction_comps, voigt_map

HIGHEST = jax.lax.Precision.HIGHEST
DEGREES = (1, 2, 3, 4)  # degrees the kernel is tested for, dims 2 and 3
DEFAULT_BLOCK = 16  # fastest on the H100 (PERF.md)
DEFAULT_WARPS = 4


def _pow2(n: int) -> int:
    """Smallest power of two >= n and >= 16 (Triton's dot minimum)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def _vel_volume(f, G, D, mat, dim):
    # div(sigma)_c = sum_r D_r( sum_d Ginv[r, d] sigma_{cd} ): the
    # per-element weights commute with D_r, so dim * dim products
    V = voigt_map(dim)
    out = []
    for c in range(dim):
        s_c = [f(V[c, d]) for d in range(dim)]
        out.append(sum(D(sum(G[r][d] * s_c[d] for d in range(dim)), r)
                       for r in range(dim)))
    return out


def _vel_face(own, nbr, nrm, coef, mat, dim):
    t_own = traction_comps(nrm.__getitem__, own, dim)
    t_nbr = traction_comps(nrm.__getitem__, nbr, dim)
    return [0.5 * tn + coef * to for tn, to in zip(t_nbr, t_own)]


def _stress_volume(f, G, D, mat, dim):
    u = [f(c) for c in range(dim)]
    Du = [[D(u[c], r) for c in range(dim)] for r in range(dim)]

    def gd(c, d):  # du_c / dx_d
        return sum(G[r][d] * Du[r][c] for r in range(dim))

    return hooke_comps(mat["lam"], mat["mu"], gd, dim)


def _stress_face(own, nbr, nrm, coef, mat, dim):
    du = [0.5 * nbr(c) + coef * own(c) for c in range(dim)]
    return hooke_comps(mat["lam"], mat["mu"],
                       lambda c, d: nrm[d] * du[c], dim)


class _Physics(NamedTuple):
    name: str
    volume: Callable  # (load, Ginv, D, materials, dim) -> out tiles
    face: Callable  # (own, nbr, normals, coef, materials, dim) -> jumps
    materials: tuple  # per-element ElasticParams fields the physics reads
    coef: str  # the ElasticParams field holding the BC flux coefficient
    out: str  # "dim" or "n_sig": output components
    scale_rho: bool  # multiply the result by 1/rho


_VEL = _Physics("dg_vel_op", _vel_volume, _vel_face, ("inv_rho",),
                "beta_t", "dim", True)
_STRESS = _Physics("dg_stress_op", _stress_volume, _stress_face,
                   ("lam", "mu"), "delta_u", "n_sig", False)


def _kernel(physics, E, n_p, nf, nfp, dim, c_in, c_out, BE, NP, NFP,
            f_ref, nbr_ref, fnode_ref, drt_ref, liftt_ref, ginv_ref,
            fscale_ref, nrm_ref, coef_ref, *refs):
    mat_refs, out_ref = refs[:-1], refs[-1]
    e = pl.program_id(0) * BE + jnp.arange(BE)
    e_ok = e < E
    e = jnp.where(e_ok, e, 0)
    j = jnp.arange(NP)
    k = jnp.arange(NFP)
    node_ok = e_ok[:, None] & (j < n_p)[None, :]
    fnode_ok = e_ok[:, None] & (k < nfp)[None, :]

    def load(ref, idx, mask):
        return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask,
                          other=0.0)

    def col(ref, i, stride):  # (BE, 1) column of a per-element table
        return load(ref, e * stride + i, e_ok)[:, None]

    node = e[:, None] * n_p + j[None, :]
    G = [[col(ginv_ref, r * dim + d, dim * dim) for d in range(dim)]
         for r in range(dim)]
    mat = {name: col(ref, 0, 1)
           for name, ref in zip(physics.materials, mat_refs)}

    def D(x, r):  # reference derivative along r: x @ Dr[r]^T
        return pl.dot(x, drt_ref[r], precision=HIGHEST)

    acc = physics.volume(lambda c: load(f_ref, node * c_in + c, node_ok),
                         G, D, mat, dim)
    for fc in range(nf):
        own_node = e[:, None] * n_p + fnode_ref[fc][None, :]
        nbr_node = plgpu.load(
            nbr_ref.at[jnp.where(fnode_ok,
                                 (e[:, None] * nf + fc) * nfp + k, 0)],
            mask=fnode_ok, other=0)
        nrm = [col(nrm_ref, fc * dim + d, nf * dim) for d in range(dim)]
        jump = physics.face(
            lambda c: load(f_ref, own_node * c_in + c, fnode_ok),
            lambda c: load(f_ref, nbr_node * c_in + c, fnode_ok),
            nrm, col(coef_ref, fc, nf), mat, dim)
        fscale = col(fscale_ref, fc, nf)
        liftt = liftt_ref[fc]
        acc = [a + pl.dot(jmp * fscale, liftt, precision=HIGHEST)
               for a, jmp in zip(acc, jump)]
    for c in range(c_out):
        res = mat["inv_rho"] * acc[c] if physics.scale_rho else acc[c]
        # masked-off lanes point past the end: a GPU never writes them, and
        # the interpreter's scatter drops them instead of racing on index 0
        plgpu.store(out_ref.at[jnp.where(node_ok, node * c_out + c,
                                         E * n_p * c_out)],
                    res, mask=node_ok)


def _tables(p: ElasticParams, NP: int, NFP: int):
    """Zero-padded Dr^T (dim, NP, NP), per-face LIFT^T (nf, NFP, NP) and
    face nodes (nf, NFP)."""
    n_p, nf, nfp = p.n_p, p.n_faces, p.n_fp
    drt = jnp.zeros((p.dim, NP, NP), p.Dr.dtype)
    drt = drt.at[:, :n_p, :n_p].set(jnp.swapaxes(p.Dr, 1, 2))
    liftt = jnp.zeros((nf, NFP, NP), p.LIFT.dtype)
    liftt = liftt.at[:, :nfp, :n_p].set(p.LIFT.T.reshape(nf, nfp, n_p))
    fnode = np.zeros((nf, NFP), np.int32)
    fnode[:, :nfp] = np.asarray(p.fnodes, np.int32)
    return drt, liftt, jnp.asarray(fnode)


def apply_op(physics, p: ElasticParams, field: jax.Array,
             block: int = DEFAULT_BLOCK, interpret: bool = False,
             num_warps: int = DEFAULT_WARPS) -> jax.Array:
    """One operator application; ``physics`` is ``_VEL`` or ``_STRESS``."""
    E, n_p, c_in = field.shape
    c_out = getattr(p, physics.out)
    NP, NFP = _pow2(n_p), _pow2(p.n_fp)
    drt, liftt, fnode = _tables(p, NP, NFP)
    mats = [getattr(p, name) for name in physics.materials]
    kern = functools.partial(
        _kernel, physics, E, n_p, p.n_faces, p.n_fp, p.dim, c_in, c_out,
        block, NP, NFP)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((E * n_p * c_out,), field.dtype),
        grid=(pl.cdiv(E, block),),
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        name=physics.name,
    )(field.reshape(-1), p.nbr.reshape(-1), fnode, drt, liftt,
      p.Ginv.reshape(-1), p.Fscale.reshape(-1), p.normals.reshape(-1),
      getattr(p, physics.coef).reshape(-1), *mats)
    return out.reshape(E, n_p, c_out)


def make_kernel_ops(block: int = DEFAULT_BLOCK, interpret: bool = False,
                    num_warps: int = DEFAULT_WARPS):
    """(vel_op, stress_op) with the signature of ops.elastic.apply_*_op."""

    def vel_op(p, sigma, pool=None):
        if pool is not None:
            raise ValueError("the fused kernel gathers from the local field "
                             "only; sharded pools run the XLA operators")
        return apply_op(_VEL, p, sigma, block, interpret, num_warps)

    def stress_op(p, u, pool=None):
        if pool is not None:
            raise ValueError("the fused kernel gathers from the local field "
                             "only; sharded pools run the XLA operators")
        return apply_op(_STRESS, p, u, block, interpret, num_warps)

    return vel_op, stress_op
