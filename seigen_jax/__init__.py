"""seigen_jax — an elastic wave propagation framework in JAX.

A from-scratch rebuild of the capabilities of devitocodes/seigen (see
SURVEY.md): the linear elastic wave equation in first-order velocity-stress
form, discretized with nodal discontinuous-Galerkin finite elements (P1-P4 on
triangles/tetrahedra) and stepped with explicit 2nd/4th-order leapfrog —
implemented as batched XLA element operators (and one fused Pallas/Triton
kernel per operator on a GPU) inside a jitted ``lax.scan`` time loop,
sharded SPMD over device meshes with ``shard_map`` halo exchange.
"""

import os as _os

__version__ = "0.1.0"

# Wave propagation accumulates matmul rounding over thousands of steps, and
# reduced-precision matmul passes (TF32, bf16) cost eigenmode accuracy.
# Default to full-precision f32 matmuls; override with
# SEIGEN_MATMUL_PRECISION (any jax_default_matmul_precision value, or
# "unset" to leave JAX's default) after checking scripts/precision_study.py.
_prec = _os.environ.get("SEIGEN_MATMUL_PRECISION", "highest")
if _prec != "unset":
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", _prec)
