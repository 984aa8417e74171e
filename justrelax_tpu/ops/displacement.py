"""Displacement ↔ velocity conversion (strain-increment formulation).

Reference: src/types/displacement.jl:1-70 and the ``strain_increment=true``
driver branch (Stokes2D.jl:659-712). With a fixed timestep the displacement
formulation is algebraically identical to the velocity one — U = V·dt,
Δε = ε·dt — so the JAX-native solvers take one set of arrays and these
conversions sit at the boundary: drive the BCs in displacement
(``DisplacementBoundaryConditions``), convert to velocity at solve entry,
convert back for output. XLA fuses the scalings, so keeping both array
families live (as the reference does) would only cost memory traffic.
"""

from __future__ import annotations

from typing import Any

Array = Any

__all__ = ["velocity2displacement", "displacement2velocity"]


def velocity2displacement(stokes, dt):
    """U ← V·dt on every node (reference velocity2displacement!)."""
    V = stokes.V
    U = stokes.U.replace(
        Ux=V.Vx * dt,
        Uy=V.Vy * dt,
        Uz=None if V.Vz is None else V.Vz * dt,
    )
    return stokes.replace(U=U)


def displacement2velocity(stokes, dt, flow_bc=None):
    """V ← U/dt (reference displacement2velocity!). With a
    ``DisplacementBoundaryConditions`` ``flow_bc``, the BCs were applied to U;
    the converted V then satisfies the equivalent velocity BCs (linear map)."""
    from justrelax_tpu.ops.bc import (
        DisplacementBoundaryConditions,
        VelocityBoundaryConditions,
    )

    if flow_bc is not None and isinstance(flow_bc, VelocityBoundaryConditions) \
            and not isinstance(flow_bc, DisplacementBoundaryConditions):
        return stokes  # velocity-driven problem: nothing to convert
    U = stokes.U
    inv_dt = 1.0 / dt
    V = stokes.V.replace(
        Vx=U.Ux * inv_dt,
        Vy=U.Uy * inv_dt,
        Vz=None if U.Uz is None else U.Uz * inv_dt,
    )
    return stokes.replace(V=V)
