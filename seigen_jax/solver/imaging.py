"""Seismic imaging post-processing on element fields (RTM support).

Reverse-time migration in the adjoint-state formulation: the zero-lag
cross-correlation image of forward and back-propagated wavefields IS the
misfit gradient evaluated in a smooth (reflector-free) background model
— so imaging reuses the FWI gradient engines unchanged (every
``--grad-path``, every parallel axis; see docs/fwi.md).  What imaging
adds over inversion is *post-processing* of the raw gradient, which this
module provides on unstructured per-element fields:

- :func:`laplacian_filter` — the standard low-wavenumber artifact
  removal (backscatter along the diving-wave path produces a smooth
  imprint; reflectivity is the oscillatory part).  On an element graph
  the (negative, scaled) Laplacian is ``g - mean(neighbours)``; the
  filter applies it ``iters`` times.
- :func:`acquisition_mute` — taper out the source/receiver imprint
  (the gradient is singular at injection/sampling points).
- :func:`normalize` — unit max-abs scaling for plotting/stacking.

The reference framework (forward modelling only, SURVEY.md §2) had no
imaging; this is beyond-parity capability built on the adjoint stack.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def element_neighbours(p) -> np.ndarray:
    """(E, nf) producer-element index per face from the face pairing.

    ``p.nbr`` decodes to the producer element of each face (boundary
    faces self-pair — the graph has implicit Neumann edges there), the
    same decoding used by ``solver.fwi.make_smoother``.
    """
    nbr = np.asarray(p.nbr)
    return np.asarray(nbr[:, :, 0] // p.n_p, np.int32)


def laplacian_filter(p, g, iters: int = 1):
    """High-pass ``g`` on the element adjacency graph ((E,) -> (E,)).

    One application returns ``g - mean_f g[nbr_f]`` (the negated graph
    Laplacian up to the face-count factor); ``iters`` applications
    sharpen further.  Removes the smooth diving-wave backscatter that
    otherwise dominates RTM images of reflectors.
    """
    e2 = jnp.asarray(element_neighbours(p))
    g = jnp.asarray(g)
    for _ in range(iters):
        g = g - jnp.mean(jnp.take(g, e2, axis=0), axis=1)
    return g


def acquisition_mute(centroids, points, radius: float):
    """(E,) smooth mute factor: 0 at acquisition points -> 1 outside.

    ``points``: (P, dim) source/receiver positions; the mute is a
    product of smoothstep ramps in distance, so overlapping points
    compose without sharp edges (sharp masks ring under the Laplacian
    filter).
    """
    cent = np.asarray(centroids, np.float64)
    m = np.ones(len(cent))
    for q in np.atleast_2d(np.asarray(points, np.float64)):
        t = np.clip(np.linalg.norm(cent - q, axis=1) / radius, 0.0, 1.0)
        m *= t * t * (3.0 - 2.0 * t)
    return m


def normalize(g):
    """Unit max-abs scaling (returns g unchanged if identically zero)."""
    g = np.asarray(g)
    m = np.abs(g).max()
    return g / m if m > 0 else g


def source_illumination(p, state0, dt, n_steps, shots, damp=None,
                        segment=None):
    """(E,) source-side illumination sum over shots, steps, nodes,
    components of u^2, via a jitted einsum-step scan (one forward per
    shot in the background model).

    RTM deconvolution weight: in 3D the forward-field ENERGY decays like
    r^-2 (vs r^-1 in 2D), so a raw cross-correlation image is strongly
    shallow-weighted — compensation ``image / (I + eps I_max)`` is what
    makes 3D depths readable.
    """
    import jax
    import jax.lax as lax

    from .timestep import make_step

    elems = np.asarray(shots.elems)
    n_shots = 1 if elems.ndim == 1 else elems.shape[0]
    if elems.ndim == 1:
        shots = jax.tree.map(lambda x: jnp.asarray(x)[None], shots)

    @jax.jit
    def illum_one(src_k):
        step = make_step(p, dt, order=4, src=src_k, damp=damp)

        def body(carry, k):
            st, acc = carry
            st = step(st, k * jnp.asarray(dt, acc.dtype))
            return (st, acc + jnp.sum(st.u * st.u, axis=(1, 2))), None

        acc0 = jnp.zeros((state0.u.shape[0],), state0.u.dtype)
        (_, acc), _ = lax.scan(body, (state0, acc0), jnp.arange(n_steps))
        return acc

    tot = np.zeros(state0.u.shape[0], np.float64)
    for k in range(n_shots):
        src_k = jax.tree.map(lambda x, k=k: x[k], shots)
        tot += np.asarray(illum_one(src_k), np.float64)
    return tot


def rtm_image(vg, theta_bg: dict, field: str = "vp"):
    """Evaluate an FWI value-and-gradient engine as a migration.

    ``vg``: any shots-stacked gradient callable (e.g. from
    ``solver.adjoint.make_fwi_gradient``) with observed data recorded in
    the TRUE model; ``theta_bg``: the smooth background.  Returns
    ``(misfit, raw_image)`` where the image is the gradient w.r.t.
    ``field`` — reflectivity up to sign and illumination.
    """
    v, g = vg(theta_bg)
    if field not in g:
        raise KeyError(f"gradient has no field {field!r}; has {list(g)}")
    return float(v), np.asarray(g[field])
