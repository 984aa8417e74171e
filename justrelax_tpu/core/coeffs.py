"""Pseudo-transient (PT) relaxation coefficients.

The accelerated pseudo-transient method (Räss et al. 2022, GMD) augments the
elliptic Stokes/diffusion problems with pseudo-time derivatives; its
convergence rate hinges on the damping coefficients below. Formulas mirror the
reference exactly (they are the convergence-rate oracle):

- Stokes (reference src/types/stokes.jl:202-228):
    Vpdτ = CFL · min(di),  lτ = min(li)
    θ_dτ = lτ (r + 4/3) / (Re · Vpdτ)
    ηdτ  = Vpdτ · lτ / Re
  defaults Re = 3π, r = 0.7, CFL = 0.9/√2.1 (2D) or 0.9/√3.1 (3D).

- Thermal diffusion (reference src/thermal_diffusion/DiffusionPT_coefficients.jl:18-28):
    Re   = π + √(π² + ρCp · max(li)² / (K dt))    (cellwise)
    θr_dτ = max(li) / Vpdτ / Re
    dτ_ρ  = Vpdτ · max(li) / (K Re)
  defaults ϵ = 1e-8, CFL = 0.9/√3.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import jax.numpy as jnp

from justrelax_tpu.core.pytree import dataclass, field

Array = Any

__all__ = ["PTStokesCoeffs", "PTThermalCoeffs"]


@dataclass
class PTStokesCoeffs:
    CFL: float = field(static=True)
    eps_rel: float = field(static=True)
    eps_abs: float = field(static=True)
    Re: float = field(static=True)
    r: float = field(static=True)
    Vpdtau: float = field(static=True)
    theta_dtau: float = field(static=True)
    etadtau: float = field(static=True)

    @classmethod
    def make(
        cls,
        li: Tuple[float, ...],
        di: Tuple[float, ...],
        eps_rel: float = 1.0e-6,
        eps_abs: float = 1.0e-12,
        Re: float = 3.0 * math.pi,
        CFL: Optional[float] = None,
        r: float = 0.7,
    ) -> "PTStokesCoeffs":
        ndim = len(li)
        if CFL is None:
            CFL = 0.9 / math.sqrt(2.1) if ndim == 2 else 0.9 / math.sqrt(3.1)
        ltau = min(li)
        Vpdtau = min(di) * CFL
        theta_dtau = ltau * (r + 4.0 / 3.0) / (Re * Vpdtau)
        etadtau = Vpdtau * ltau / Re
        return cls(
            CFL=float(CFL),
            eps_rel=float(eps_rel),
            eps_abs=float(eps_abs),
            Re=float(Re),
            r=float(r),
            Vpdtau=float(Vpdtau),
            theta_dtau=float(theta_dtau),
            etadtau=float(etadtau),
        )


@dataclass
class PTThermalCoeffs:
    """Cellwise PT coefficients for the thermal diffusion solver.

    ``theta_r_dtau`` and ``dtau_rho`` are arrays of shape ``ni`` (cell
    centers); scalars are static.
    """

    CFL: float = field(static=True)
    eps: float = field(static=True)
    max_lxyz: float = field(static=True)
    Vpdtau: float = field(static=True)
    theta_r_dtau: Array = None
    dtau_rho: Array = None

    @classmethod
    def make(
        cls,
        K: Array,
        rho_Cp: Array,
        dt: float,
        di: Tuple[float, ...],
        li: Tuple[float, ...],
        eps: float = 1.0e-8,
        CFL: float = 0.9 / math.sqrt(3.0),
    ) -> "PTThermalCoeffs":
        """From conductivity / volumetric heat capacity arrays (or scalars)."""
        Vpdtau = min(di) * CFL
        max_lxyz = max(li)
        K = jnp.asarray(K)
        rho_Cp = jnp.asarray(rho_Cp)
        Re = jnp.pi + jnp.sqrt(jnp.pi**2 + rho_Cp * max_lxyz**2 / K / dt)
        theta_r_dtau = max_lxyz / Vpdtau / Re
        dtau_rho = Vpdtau * max_lxyz / K / Re
        return cls(
            CFL=float(CFL),
            eps=float(eps),
            max_lxyz=float(max_lxyz),
            Vpdtau=float(Vpdtau),
            theta_r_dtau=theta_r_dtau,
            dtau_rho=dtau_rho,
        )

    @classmethod
    def from_material(
        cls,
        material,
        T_center: Array,
        P: Array,
        dt: float,
        di: Tuple[float, ...],
        li: Tuple[float, ...],
        phase_ratios: Optional[Array] = None,
        eps: float = 1.0e-8,
        CFL: float = 0.9 / math.sqrt(3.0),
    ) -> "PTThermalCoeffs":
        """From a material model evaluated at cell centers.

        ``T_center`` is the interior temperature (shape ``ni``, i.e. ``T`` with
        ghosts stripped). Mirrors reference ``compute_pt_thermal_arrays!``
        (DiffusionPT_coefficients.jl:124-155).
        """
        from justrelax_tpu.rheology.materials import compute_rhoCp, compute_conductivity

        Vpdtau = min(di) * CFL
        max_lxyz = max(li)
        rho_Cp = compute_rhoCp(material, T=T_center, P=P, phase_ratios=phase_ratios)
        K = compute_conductivity(material, T=T_center, P=P, phase_ratios=phase_ratios)
        inv_Re = 1.0 / (jnp.pi + jnp.sqrt(jnp.pi**2 + rho_Cp * max_lxyz**2 / (K * dt)))
        theta_r_dtau = max_lxyz / Vpdtau * inv_Re
        dtau_rho = Vpdtau * max_lxyz / K * inv_Re
        return cls(
            CFL=float(CFL),
            eps=float(eps),
            max_lxyz=float(max_lxyz),
            Vpdtau=float(Vpdtau),
            theta_r_dtau=theta_r_dtau,
            dtau_rho=dtau_rho,
        )
