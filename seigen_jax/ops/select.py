"""Engine choice, in one place, from what the run can observe.

Every entry point (``ElasticSimulation``, scripts/explosive_source.py,
bench.py) asks :func:`choose_impl` which operator engine runs, and
:func:`make_ops` builds its (vel_op, stress_op) pair.  The engines:

  ``triton``   fused Pallas/Triton kernel per operator (ops/dg_kernel.py);
               GPU only, float32, dims 2-3, degrees 1-4
  ``xla_roll`` XLA operators + roll-based trace exchange
               (ops/structured_exchange.py); structured meshes only
  ``einsum``   XLA operators + face-owner gather (ops/elastic.py): the
               oracle, and the path for every mesh
  ``upwind``   Godunov flux + RK4 in XLA (ops/upwind.py, solver/rk4.py)
  ``cpml``     split operators + RK4 in XLA (solver/pml.py)
  ``general``  domain decomposition with ppermute halos
               (parallel/dist_ops.py) on the einsum operators
"""

from __future__ import annotations

import numpy as np

from .dg_kernel import DEGREES as KERNEL_DEGREES

OPERATOR_IMPLS = ("einsum", "xla_roll", "triton")

#: XLA operators for structured meshes when the kernel is not eligible:
#: the faster of the roll exchange and the face-owner gather on the H100
#: (the gather, by 12.6x over the flagship scan; PERF.md).
XLA_STRUCTURED = "einsum"


def kernel_eligible(platform: str, dim: int, degree: int, dtype) -> bool:
    return (platform == "gpu" and dim in (2, 3) and degree in KERNEL_DEGREES
            and np.dtype(dtype) == np.float32)


def choose_impl(platform: str, structured: bool, *, dim: int, degree: int,
                dtype=np.float32, scheme: str = "lf", aniso: bool = False,
                pml: bool = False, shards: int = 0) -> str:
    """The engine ``--impl auto`` runs for this platform, mesh, scheme and
    physics (see the module docstring for the names)."""
    if shards:
        return "general"
    if pml:
        return "cpml"
    if scheme != "lf":
        return "upwind"
    if aniso:
        return "einsum"
    if kernel_eligible(platform, dim, degree, dtype):
        return "triton"
    return XLA_STRUCTURED if structured else "einsum"


def resolve_impl(impl: str, platform: str, dm, dtype) -> str:
    """Validate an operator engine for the central-flux LF path (``auto``
    resolves through :func:`choose_impl`)."""
    from .structured_exchange import detect_structured

    if impl == "auto":
        return choose_impl(platform, detect_structured(dm) is not None,
                           dim=dm.dim, degree=dm.re.degree, dtype=dtype)
    if impl not in OPERATOR_IMPLS:
        raise ValueError(f"unknown impl {impl!r} (choose from "
                         f"auto, {', '.join(OPERATOR_IMPLS)})")
    if impl == "triton" and not kernel_eligible(platform, dm.dim,
                                                dm.re.degree, dtype):
        raise ValueError("impl 'triton' needs a GPU, float32, dim 2-3 and "
                         f"degree {KERNEL_DEGREES[0]}-{KERNEL_DEGREES[-1]}")
    if impl == "xla_roll" and detect_structured(dm) is None:
        raise ValueError("impl 'xla_roll' needs a structured mesh")
    return impl


def make_ops(impl: str, p, dm=None):
    """(vel_op, stress_op) of an operator engine, signature-compatible with
    ops.elastic.apply_*_op (``dm`` is needed for ``xla_roll``)."""
    from .elastic import apply_stress_op, apply_vel_op

    if impl == "einsum":
        return apply_vel_op, apply_stress_op
    if impl == "xla_roll":
        from .structured_exchange import detect_structured, make_structured_ops

        ex = detect_structured(dm)
        if ex is None:
            raise ValueError("impl 'xla_roll' needs a structured mesh")
        return make_structured_ops(p, ex)
    if impl == "triton":
        from .dg_kernel import make_kernel_ops

        return make_kernel_ops()
    raise ValueError(f"impl {impl!r} has no operator pair")
