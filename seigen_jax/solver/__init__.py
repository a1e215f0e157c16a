from .analytic import (ExplosionGreens3D, ForceGreens3D,
                       MomentGreens3D, PlaneWave)
from .damping import absorbing_bc_fn, sponge_mask
from .errors import convergence_order, interpolate, l2_error, l2_norm
from .receivers import ReceiverData, build_receivers, grid, line, sample
from .source import (PointSource, SourceData, build_sources,
                     kinematic_rupture, ricker)
from .pml import (CpmlState, cpml_init, cpml_profiles, make_cpml_rhs,
                  run_cpml)
from .rk4 import make_rk4_step, run_rk4
from .timestep import State, cfl_dt, make_step, run, run_jit, staggered_init

__all__ = [
    "ExplosionGreens3D",
    "ForceGreens3D",
    "MomentGreens3D",
    "PlaneWave",
    "absorbing_bc_fn",
    "sponge_mask",
    "convergence_order",
    "interpolate",
    "l2_error",
    "l2_norm",
    "ReceiverData",
    "build_receivers",
    "grid",
    "line",
    "sample",
    "PointSource",
    "SourceData",
    "build_sources",
    "kinematic_rupture",
    "ricker",
    "CpmlState",
    "cpml_init",
    "cpml_profiles",
    "make_cpml_rhs",
    "run_cpml",
    "State",
    "cfl_dt",
    "make_step",
    "run",
    "run_jit",
    "staggered_init",
    "make_rk4_step",
    "run_rk4",
]
