"""Immutable pytree state containers for the solvers.

JAX-native equivalents of the reference's mutable field structs
(/root/reference/src/types/stokes.jl:161-193, heat_diffusion.jl:1-15,
constructors at src/types/constructors/{stokes,heat_diffusion}.jl). Staggered
shapes are identical to the reference (they encode the discretization and the
test oracle):

2D (``ni = (nx, ny)``):
  - cell centers ``(nx, ny)``: P, P0, ∇V, Q, τ.xx/yy/xy_c, ε.*, EII_pl, λ, ΔPψ
  - vertices ``(nx+1, ny+1)``: τ.xy, τ.xx_v/yy_v, ω.xy, λv, viscosity.ηv
  - velocities with ghost rows on the transverse axis:
      Vx ``(nx+1, ny+2)``, Vy ``(nx+2, ny+1)``
  - momentum residuals Rx ``(nx-1, ny)``, Ry ``(nx, ny-1)``
  - temperature with one ghost node per face: T ``(nx+2, ny+2)``
  - heat fluxes qTx ``(nx+1, ny)``, qTy ``(nx, ny+1)``

3D adds z-analogues (Vz ``(nx+2, ny+2, nz+1)``, shear components yz/xz, ...).

All containers are frozen pytree dataclasses (core/pytree.py): every field
is a JAX array
leaf, solvers consume a state and return a new one, and ``jax.jit`` treats
them as pytrees. Use ``state.replace(field=new_value)`` for updates.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp

from justrelax_tpu.core.pytree import dataclass

Array = Any

__all__ = [
    "Velocity",
    "Displacement",
    "Vorticity",
    "Viscosity",
    "SymmetricTensor",
    "Residual",
    "StokesState",
    "ThermalState",
]


def _zeros(shape, dtype):
    return jnp.zeros(shape, dtype=dtype)


@dataclass
class Velocity:
    Vx: Array
    Vy: Array
    Vz: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "Velocity":
        if len(ni) == 2:
            nx, ny = ni
            return cls(
                Vx=_zeros((nx + 1, ny + 2), dtype),
                Vy=_zeros((nx + 2, ny + 1), dtype),
            )
        nx, ny, nz = ni
        return cls(
            Vx=_zeros((nx + 1, ny + 2, nz + 2), dtype),
            Vy=_zeros((nx + 2, ny + 1, nz + 2), dtype),
            Vz=_zeros((nx + 2, ny + 2, nz + 1), dtype),
        )

    @property
    def components(self):
        if self.Vz is None:
            return (self.Vx, self.Vy)
        return (self.Vx, self.Vy, self.Vz)


@dataclass
class Displacement:
    Ux: Array
    Uy: Array
    Uz: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "Displacement":
        v = Velocity.make(ni, dtype)
        return cls(Ux=v.Vx, Uy=v.Vy, Uz=v.Vz)

    @property
    def components(self):
        if self.Uz is None:
            return (self.Ux, self.Uy)
        return (self.Ux, self.Uy, self.Uz)


@dataclass
class Vorticity:
    xy: Array
    yz: Optional[Array] = None
    xz: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "Vorticity":
        if len(ni) == 2:
            nx, ny = ni
            return cls(xy=_zeros((nx + 1, ny + 1), dtype))
        nx, ny, nz = ni
        return cls(
            xy=_zeros((nx + 1, ny + 1, nz), dtype),
            yz=_zeros((nx, ny + 1, nz + 1), dtype),
            xz=_zeros((nx + 1, ny, nz + 1), dtype),
        )


@dataclass
class Viscosity:
    """η (centers), ηv (vertices), η_vep (centers), ητ (PT preconditioner)."""

    eta: Array
    eta_v: Array
    eta_vep: Array
    eta_tau: Array

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "Viscosity":
        ni_v = tuple(n + 1 for n in ni)
        return cls(
            eta=jnp.ones(ni, dtype),
            eta_v=jnp.ones(ni_v, dtype),
            eta_vep=jnp.ones(ni, dtype),
            eta_tau=_zeros(ni, dtype),
        )


@dataclass
class SymmetricTensor:
    """Symmetric (stress/strain-rate) tensor on the staggered grid.

    Normal components live at centers (xx, yy, zz) and vertices (xx_v, ...);
    shear components live at vertices (xy, yz, xz) and centers (xy_c, ...);
    II is the second invariant at centers.
    """

    xx: Array
    yy: Array
    xx_v: Array
    yy_v: Array
    xy: Array
    xy_c: Array
    II: Array
    zz: Optional[Array] = None
    zz_v: Optional[Array] = None
    yz: Optional[Array] = None
    xz: Optional[Array] = None
    yz_c: Optional[Array] = None
    xz_c: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "SymmetricTensor":
        if len(ni) == 2:
            nx, ny = ni
            nv = (nx + 1, ny + 1)
            return cls(
                xx=_zeros(ni, dtype),
                yy=_zeros(ni, dtype),
                xx_v=_zeros(nv, dtype),
                yy_v=_zeros(nv, dtype),
                xy=_zeros(nv, dtype),
                xy_c=_zeros(ni, dtype),
                II=_zeros(ni, dtype),
            )
        nx, ny, nz = ni
        nv = (nx + 1, ny + 1, nz + 1)
        return cls(
            xx=_zeros(ni, dtype),
            yy=_zeros(ni, dtype),
            zz=_zeros(ni, dtype),
            xx_v=_zeros(nv, dtype),
            yy_v=_zeros(nv, dtype),
            zz_v=_zeros(nv, dtype),
            xy=_zeros((nx + 1, ny + 1, nz), dtype),
            yz=_zeros((nx, ny + 1, nz + 1), dtype),
            xz=_zeros((nx + 1, ny, nz + 1), dtype),
            xy_c=_zeros(ni, dtype),
            yz_c=_zeros(ni, dtype),
            xz_c=_zeros(ni, dtype),
            II=_zeros(ni, dtype),
        )

    @property
    def normal(self):
        if self.zz is None:
            return (self.xx, self.yy)
        return (self.xx, self.yy, self.zz)

    @property
    def shear(self):
        if self.zz is None:
            return (self.xy,)
        return (self.yz, self.xz, self.xy)


@dataclass
class Residual:
    RP: Array
    Rx: Array
    Ry: Array
    Rz: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "Residual":
        if len(ni) == 2:
            nx, ny = ni
            return cls(
                RP=_zeros(ni, dtype),
                Rx=_zeros((nx - 1, ny), dtype),
                Ry=_zeros((nx, ny - 1), dtype),
            )
        nx, ny, nz = ni
        return cls(
            RP=_zeros(ni, dtype),
            Rx=_zeros((nx - 1, ny, nz), dtype),
            Ry=_zeros((nx, ny - 1, nz), dtype),
            Rz=_zeros((nx, ny, nz - 1), dtype),
        )


@dataclass
class StokesState:
    """Full Stokes solver state (reference StokesArrays, stokes.jl:161-193)."""

    P: Array
    P0: Array
    V: Velocity
    grad_V: Array
    Q: Array
    tau: SymmetricTensor
    eps: SymmetricTensor
    eps_pl: SymmetricTensor
    EII_pl: Array
    EVol_pl: Array
    eps_vol_pl: Array
    viscosity: Viscosity
    tau_o: SymmetricTensor
    R: Residual
    U: Displacement
    omega: Vorticity
    d_eps: SymmetricTensor
    grad_U: Array
    lam: Array
    lam_v: Array
    dP_psi: Array

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "StokesState":
        ni = tuple(int(n) for n in ni)
        ni_v = tuple(n + 1 for n in ni)
        return cls(
            P=_zeros(ni, dtype),
            P0=_zeros(ni, dtype),
            V=Velocity.make(ni, dtype),
            grad_V=_zeros(ni, dtype),
            Q=_zeros(ni, dtype),
            tau=SymmetricTensor.make(ni, dtype),
            eps=SymmetricTensor.make(ni, dtype),
            eps_pl=SymmetricTensor.make(ni, dtype),
            EII_pl=_zeros(ni, dtype),
            EVol_pl=_zeros(ni, dtype),
            eps_vol_pl=_zeros(ni, dtype),
            viscosity=Viscosity.make(ni, dtype),
            tau_o=SymmetricTensor.make(ni, dtype),
            R=Residual.make(ni, dtype),
            U=Displacement.make(ni, dtype),
            omega=Vorticity.make(ni, dtype),
            d_eps=SymmetricTensor.make(ni, dtype),
            grad_U=_zeros(ni, dtype),
            lam=_zeros(ni, dtype),
            lam_v=_zeros(ni_v, dtype),
            dP_psi=_zeros(ni, dtype),
        )

    @property
    def ni(self) -> Tuple[int, ...]:
        return self.P.shape

    @property
    def ndim(self) -> int:
        return self.P.ndim


@dataclass
class ThermalState:
    """Thermal solver state (reference ThermalArrays, heat_diffusion.jl:1-15).

    ``T`` carries one ghost node per face: shape ``(nx+2, ny+2[, nz+2])``.
    Fluxes live on interior cell faces; sources/residual at cell centers.
    """

    T: Array
    Told: Array
    dT: Array
    adiabatic: Array
    dT_dt: Array
    qTx: Array
    qTy: Array
    qTx2: Array
    qTy2: Array
    H: Array
    shear_heating: Array
    ResT: Array
    qTz: Optional[Array] = None
    qTz2: Optional[Array] = None

    @classmethod
    def make(cls, ni: Tuple[int, ...], dtype=None) -> "ThermalState":
        ni = tuple(int(n) for n in ni)
        ni_g = tuple(n + 2 for n in ni)
        if len(ni) == 2:
            nx, ny = ni
            qx, qy, qz = (nx + 1, ny), (nx, ny + 1), None
        else:
            nx, ny, nz = ni
            qx = (nx + 1, ny, nz)
            qy = (nx, ny + 1, nz)
            qz = (nx, ny, nz + 1)
        return cls(
            T=_zeros(ni_g, dtype),
            Told=_zeros(ni_g, dtype),
            dT=_zeros(ni_g, dtype),
            adiabatic=_zeros(ni, dtype),
            dT_dt=_zeros(ni, dtype),
            qTx=_zeros(qx, dtype),
            qTy=_zeros(qy, dtype),
            qTx2=_zeros(qx, dtype),
            qTy2=_zeros(qy, dtype),
            qTz=_zeros(qz, dtype) if qz is not None else None,
            qTz2=_zeros(qz, dtype) if qz is not None else None,
            H=_zeros(ni, dtype),
            shear_heating=_zeros(ni, dtype),
            ResT=_zeros(ni, dtype),
        )

    @property
    def ni(self) -> Tuple[int, ...]:
        return self.H.shape

    @property
    def T_inner(self) -> Array:
        """Interior (non-ghost) temperature view."""
        if self.T.ndim == 2:
            return self.T[1:-1, 1:-1]
        return self.T[1:-1, 1:-1, 1:-1]
