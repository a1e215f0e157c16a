"""High-level simulation facade — API parity with the reference's ElasticLF4.

The reference exposes ``ElasticLF4(mesh, family, degree, dim, explicit=...)``
with material attributes and a ``run(T)`` loop (SURVEY.md §2 layer 2).  The
equivalent here is a frozen config + a facade object wiring mesh,
material, sources, receivers, boundaries, damping, and the jitted scan
together, with checkpoint/VTK hooks.  All state is explicit; nothing global.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh import MeshTopology, build_discrete
from ..ops import Material, build_params, n_sig_for
from .damping import absorbing_bc_fn, sponge_mask
from .receivers import build_receivers, sample
from .source import PointSource, build_sources
from .timestep import State, cfl_dt, make_step, run, staggered_init


@dataclass(frozen=True)
class SimConfig:
    """Frozen run configuration (SURVEY.md §7.6: one dataclass per run)."""

    degree: int = 2
    order: int = 4  # LF2 | LF4
    cfl: float = 0.4
    dtype: str = "float32"
    impl: str = "auto"  # auto|einsum|xla_roll|triton (ops/select.py)
    free_sides: tuple = ()  # ((axis, "lo"|"hi"), ...)
    absorbing_sides: tuple = ()  # rest default to free surface
    sponge_width: float = 0.0
    sponge_alpha: float = 2.0
    scheme: str = "lf"  # lf (central flux + leapfrog) | upwind-rk4
    # viscoelastic attenuation (upwind-rk4 scheme only); None = elastic
    q_kappa: float | None = None
    q_mu: float | None = None
    q_band: tuple | None = None  # (f_min, f_max); required with q_*


class ElasticSimulation:
    """Facade: build once, then step/run/sample.

    Reference-parity surface:
      sim = ElasticSimulation(topo, material, config, sources=[...],
                              receiver_points=...)
      final_state, seismograms = sim.run(T)
    """

    def __init__(
        self,
        topology: MeshTopology,
        material: Material,
        config: SimConfig = SimConfig(),
        sources: list[PointSource] | None = None,
        receiver_points: np.ndarray | None = None,
        stiffness: np.ndarray | None = None,
    ):
        """``stiffness``: optional per-element Voigt stiffness
        (n_sig, n_sig) or (E, n_sig, n_sig) for anisotropic media
        (ops/anisotropic.py); forces the einsum operator path
        (central-flux LF schemes only)."""
        if topology.structure is None and not topology.periodic:
            from ..mesh.recover import recover_structure

            topology = recover_structure(topology)
        self.config = config
        self.topology = topology
        self.material = material
        dtype = jnp.dtype(config.dtype)

        bc_fn = None
        if config.absorbing_sides:
            bc_fn = absorbing_bc_fn(
                topology.extents, free_sides=list(config.free_sides)
            )
        self.dm = build_discrete(topology, config.degree, bc_fn=bc_fn)
        self.params = build_params(self.dm, material, dtype=dtype)
        self.sources = build_sources(
            self.dm, sources or [], dtype=dtype, mat=material
        )
        self.receivers = (
            build_receivers(self.dm, receiver_points, dtype=dtype)
            if receiver_points is not None
            else None
        )
        self.damp = None
        if config.sponge_width > 0 and config.absorbing_sides:
            self.damp = jnp.asarray(
                sponge_mask(
                    self.dm,
                    list(config.absorbing_sides),
                    config.sponge_width,
                    config.sponge_alpha,
                ),
                dtype=dtype,
            )
        self._stiffness = None
        if stiffness is not None:
            if config.scheme != "lf":
                raise ValueError("anisotropy supports scheme='lf' only")
            n_sig = n_sig_for(self.dm.dim)
            E = self.dm.num_elements
            C = np.broadcast_to(np.asarray(stiffness),
                                (E, n_sig, n_sig))
            self._stiffness = jnp.asarray(C, dtype)
        vp_max = float(np.asarray(material.vp).max())
        if self._stiffness is not None:
            # CFL bound: phase speeds are bounded by sqrt(||C||_2/rho)
            # <= sqrt(||C||_F/rho); cheap per-element Frobenius bound
            Cf = np.asarray(self._stiffness, np.float64)
            fro = np.sqrt((Cf * Cf).sum(axis=(1, 2))).max()
            rho_min = float(np.asarray(material.rho).min())
            vp_max = max(vp_max, float(np.sqrt(fro / rho_min)))
        self.dt = cfl_dt(
            float(self.dm.h.min()), vp_max, config.degree, config.cfl
        )
        self._dtype = dtype
        self._wdata = self._visco = None
        if config.scheme == "upwind-rk4":
            from ..ops.upwind import build_upwind_data

            self._wdata = build_upwind_data(self.dm, material, dtype=dtype)
            if config.q_kappa or config.q_mu:
                if not config.q_band:
                    raise ValueError("q_band=(f_min, f_max) is required "
                                     "with q_kappa/q_mu")
                from ..ops.viscoelastic import build_visco

                self._visco = build_visco(
                    self.params, config.q_kappa or np.inf,
                    config.q_mu or np.inf, *config.q_band)
        elif config.q_kappa or config.q_mu:
            raise ValueError("attenuation requires scheme='upwind-rk4'")
        elif config.scheme != "lf":
            raise ValueError(f"unknown scheme {config.scheme!r}")

        self._vel_op, self._stress_op = self._select_ops(config.impl)
        self._runners = {}

    def _select_ops(self, impl: str):
        """Operator engine: ops/select.py decides ``auto`` from the
        platform and the mesh; an explicit engine is validated there."""
        from ..ops import apply_vel_op
        from ..ops.select import make_ops, resolve_impl

        if self._stiffness is not None:
            if impl not in ("auto", "einsum"):
                raise ValueError("anisotropic stiffness runs the einsum "
                                 f"path; impl {impl!r} unsupported")
            from ..ops.anisotropic import make_aniso_stress_op

            self._impl = "einsum"
            return apply_vel_op, make_aniso_stress_op(self._stiffness)
        self._impl = resolve_impl(impl, jax.devices()[0].platform, self.dm,
                                  self._dtype)
        return make_ops(self._impl, self.params, self.dm)

    def zero_state(self) -> State:
        E, n_p = self.dm.num_elements, self.dm.re.n_p
        dim = self.dm.dim
        return State(
            u=jnp.zeros((E, n_p, dim), dtype=self._dtype),
            s=jnp.zeros((E, n_p, n_sig_for(dim)), dtype=self._dtype),
        )

    def state_from(self, u_fn, s_fn, t: float = 0.0) -> State:
        """Staggered-consistent state from co-located analytic/callable ICs."""
        from .errors import interpolate

        u0 = jnp.asarray(interpolate(self.dm, u_fn, t), dtype=self._dtype)
        s0 = jnp.asarray(interpolate(self.dm, s_fn, t), dtype=self._dtype)
        return staggered_init(
            self.params, u0, s0, self.dt, order=self.config.order
        )

    def run(self, T: float, state: State | None = None):
        """Run to time T; returns (final State, seismograms or None).

        The jitted scan is kept per step count, so a second run of the
        same length does not trace or compile again."""
        n_steps = max(int(np.ceil(T / self.dt)), 1)
        state = state if state is not None else self.zero_state()
        if n_steps not in self._runners:
            self._runners[n_steps] = jax.jit(self._scan(n_steps))
        fin, seis = self._runners[n_steps](self.params, self._wdata,
                                           self._visco, state)
        return fin, (None if seis is None else np.asarray(seis))

    def _scan(self, n_steps: int):
        """(params, wdata, visco, State) -> (final State, seismograms)."""
        kw = dict(src=self.sources, damp=self.damp,
                  receivers=self.receivers)
        if self._visco is not None:
            from .rk4 import run_rk4_visco

            def scan(p, w, v, st):
                fin, _, seis = run_rk4_visco(p, w, v, st, self.dt, n_steps,
                                             **kw)
                return fin, seis
            return scan
        if self._wdata is not None:
            from .rk4 import run_rk4

            return lambda p, w, v, st: run_rk4(p, w, st, self.dt, n_steps,
                                               **kw)
        return lambda p, w, v, st: run(
            p, st, self.dt, n_steps, order=self.config.order,
            vel_op=self._vel_op, stress_op=self._stress_op, **kw)

    def step_fn(self):
        """The raw jittable (State, t) -> State single-step function."""
        return make_step(
            self.params,
            self.dt,
            order=self.config.order,
            src=self.sources,
            damp=self.damp,
            vel_op=self._vel_op,
            stress_op=self._stress_op,
        )

    def sample(self, state: State) -> np.ndarray | None:
        if self.receivers is None:
            return None
        return np.asarray(sample(self.receivers, state.u))
