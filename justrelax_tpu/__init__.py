"""justrelax_tpu — a JAX-native pseudo-transient geodynamics framework.

A from-scratch JAX/XLA implementation of matrix-free accelerated
pseudo-transient (APT) solvers for visco-elasto-plastic Stokes flow and thermal
diffusion on staggered Cartesian grids, with WENO5 advection, particle-in-cell
material transport, and multi-device domain decomposition over a
``jax.sharding.Mesh`` (halo exchange via collective permutes).

Capability reference: PTsolvers/JustRelax.jl (see SURVEY.md). This is not a
port — all kernels are designed for XLA fusion, state is
held in immutable pytrees, and iteration loops are ``lax.while_loop`` device
programs.
"""

from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu.core.state import StokesState, ThermalState
from justrelax_tpu.ops.bc import (
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    DisplacementBoundaryConditions,
    flow_bcs,
    thermal_bcs,
)

__version__ = "0.1.0"

__all__ = [
    "Geometry",
    "PTStokesCoeffs",
    "PTThermalCoeffs",
    "StokesState",
    "ThermalState",
    "TemperatureBoundaryConditions",
    "VelocityBoundaryConditions",
    "DisplacementBoundaryConditions",
    "flow_bcs",
    "thermal_bcs",
]
