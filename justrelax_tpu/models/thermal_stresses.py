"""Thermal stresses around a magma chamber (Kiss et al. 2023 physics).

Simplified JAX-native counterpart of the reference miniapp
miniapps/benchmarks/thermal_stress/Thermal_Stress_Magma_Chamber_nondim.jl:
a hot circular magma chamber inside compressible visco-elastic rock. Each
step: PT thermal diffusion → ΔT = T − Told → melt fraction (Caricchi) →
melt-dependent expansivity → compressible VE Stokes with the α·ΔT/dt
pressure source (PressureKernels.jl:197-206 via ops/stokes.compute_P).

Heating expands the chamber against the visco-elastic host, building an
over-pressure ~K·α·ΔT that relaxes on the host Maxwell time. Gravity is
off so the pressure anomaly is purely thermal (the full gravity +
sticky-air volcano setup is the Volcano2D/Caldera model).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState, ThermalState
from justrelax_tpu.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu.rheology.melting import (
    MeltingCaricchi,
    NoMelting,
    compute_melt_fraction,
    melt_dependent_alpha,
)
from justrelax_tpu.rheology.phases import phase_ratios_from_field
from justrelax_tpu.solvers.stokes2d import solve_ve
from justrelax_tpu.solvers.thermal import heatdiffusion_PT

KM = 1.0e3
ROCK, MAGMA = 0, 1


def run(nx=64, ny=64, nt=2, dtype=None):
    lx = ly = 20.0 * KM
    ni = (nx, ny)
    geometry = Geometry(ni, (lx, ly), origin=(-lx / 2, -ly / 2))
    X, Y = geometry.cell_centers_mesh()
    rad = 2.5 * KM
    chamber = np.asarray(X) ** 2 + np.asarray(Y) ** 2 < rad**2
    phases = np.where(chamber, MAGMA, ROCK)
    pr = phase_ratios_from_field(jnp.asarray(phases), 2)

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype

    # material fields (rock / magma)
    eta = jnp.asarray(np.where(chamber, 1.0e18, 1.0e21), dt_f)
    G = jnp.asarray(np.where(chamber, 1.0e10, 2.5e10), dt_f)
    beta = 6.0e-11  # 1/Pa, both phases (reference β_rock = β_magma = 6e-11)
    K = jnp.asarray(1.0 / beta, dt_f)
    alpha_rock, alpha_melt = 3.0e-5, 6.0e-5
    melting = (NoMelting(), MeltingCaricchi())

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, eps_abs=1.0e-8,
        CFL=0.9 / math.sqrt(2.1),
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    zeros_c = jnp.zeros(ni, dt_f)
    rho_g = (zeros_c, zeros_c)  # gravity off: isolate thermal pressurization

    # temperature: cold host, hot chamber (smooth edge to avoid ringing)
    T_host, T_magma = 273.15 + 350.0, 273.15 + 1200.0
    rr = np.sqrt(np.asarray(X) ** 2 + np.asarray(Y) ** 2)
    T0 = T_host + (T_magma - T_host) * 0.5 * (1.0 - np.tanh((rr - rad) / (0.5 * KM)))
    thermal = ThermalState.make(ni, dtype=dtype)
    Tg = np.full((nx + 2, ny + 2), T_host)
    Tg[1:-1, 1:-1] = T0
    thermal_bc = TemperatureBoundaryConditions(
        constant_value=Faces(left=T_host, right=T_host, top=T_host, bot=T_host)
    )
    Tj = thermal_bcs(jnp.asarray(Tg, dt_f), thermal_bc)
    thermal = thermal.replace(T=Tj, Told=Tj)

    rho, Cp, k_th = 2.65e3, 1.05e3, 3.0
    kappa = k_th / (rho * Cp)
    dt = 0.25 * min(geometry.di) ** 2 / kappa  # conduction-limited step
    Kfield = jnp.full(ni, k_th, dt_f)
    RhoCp = jnp.full(ni, rho * Cp, dt_f)

    info = None
    phi = None
    for _ in range(nt):
        Told = thermal.T
        pt_thermal = PTThermalCoeffs.make(
            Kfield, RhoCp, dt, geometry.di, geometry.li, eps=1.0e-8,
            CFL=0.95 / math.sqrt(2.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            K=Kfield, rho_Cp=RhoCp, iter_max=20_000, nout=200,
        )
        dT = (thermal.T - Told)[1:-1, 1:-1]

        T_c = thermal.T[1:-1, 1:-1]
        phi = compute_melt_fraction(melting, T_c, phase_ratios=pr.center)
        alpha = melt_dependent_alpha(alpha_rock, alpha_melt, phi)

        stokes, info = solve_ve(
            stokes, pt_stokes, geometry, flow_bc, rho_g, G, K, dt,
            iter_max=100_000, nout=1_000, alpha_dT=alpha * dT,
        )
        stokes = stokes.replace(P0=stokes.P)

    return stokes, thermal, phi, info, chamber


def run_3d(n=24, nt=2, dtype=None):
    """3D spherical magma chamber (reference
    Thermal_Stress_Magma_Chamber_nondim3D.jl): same Kiss et al. (2023)
    physics as :func:`run` — PT thermal diffusion → melt-dependent α →
    compressible VE Stokes with the α·ΔT/dt pressure source — on a
    spherical chamber in a 20 km box."""
    from justrelax_tpu.solvers.stokes3d import solve_ve_3d

    lx = ly = lz = 20.0 * KM
    ni = (n, n, n)
    geometry = Geometry(ni, (lx, ly, lz),
                        origin=(-lx / 2, -ly / 2, -lz / 2))
    Xc = [np.asarray(c) for c in geometry.xci]
    X, Y, Z = np.meshgrid(*Xc, indexing="ij")
    rad = 2.5 * KM
    rr = np.sqrt(X**2 + Y**2 + Z**2)
    chamber = rr < rad

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    eta = jnp.asarray(np.where(chamber, 1.0e18, 1.0e21), dt_f)
    G = jnp.asarray(np.where(chamber, 1.0e10, 2.5e10), dt_f)
    beta = 6.0e-11
    K = jnp.full(ni, 1.0 / beta, dt_f)
    alpha_rock, alpha_melt = 3.0e-5, 6.0e-5
    melting = (NoMelting(), MeltingCaricchi())
    pr = phase_ratios_from_field(jnp.asarray(chamber.astype(int)), 2)

    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-5, eps_abs=1.0e-8,
        CFL=0.9 / math.sqrt(3.1),
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    zeros_c = jnp.zeros(ni, dt_f)
    rho_g3 = (zeros_c, zeros_c, zeros_c)

    T_host, T_magma = 273.15 + 350.0, 273.15 + 1200.0
    T0 = T_host + (T_magma - T_host) * 0.5 * (
        1.0 - np.tanh((rr - rad) / (0.5 * KM))
    )
    thermal = ThermalState.make(ni, dtype=dtype)
    Tg = np.full((n + 2, n + 2, n + 2), T_host)
    Tg[1:-1, 1:-1, 1:-1] = T0
    thermal_bc = TemperatureBoundaryConditions(
        constant_value=Faces(left=T_host, right=T_host, top=T_host,
                             bot=T_host, front=T_host, back=T_host)
    )
    Tj = thermal_bcs(jnp.asarray(Tg, dt_f), thermal_bc)
    thermal = thermal.replace(T=Tj, Told=Tj)

    rho, Cp, k_th = 2.65e3, 1.05e3, 3.0
    kappa = k_th / (rho * Cp)
    dt = 0.25 * min(geometry.di) ** 2 / kappa
    Kfield = jnp.full(ni, k_th, dt_f)
    RhoCp = jnp.full(ni, rho * Cp, dt_f)

    info = None
    phi = None
    for _ in range(nt):
        Told = thermal.T
        pt_thermal = PTThermalCoeffs.make(
            Kfield, RhoCp, dt, geometry.di, geometry.li, eps=1.0e-8,
            CFL=0.95 / math.sqrt(3.0),
        )
        thermal, _ = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            K=Kfield, rho_Cp=RhoCp, iter_max=20_000, nout=200,
        )
        dT = (thermal.T - Told)[1:-1, 1:-1, 1:-1]

        T_c = thermal.T[1:-1, 1:-1, 1:-1]
        phi = compute_melt_fraction(melting, T_c, phase_ratios=pr.center)
        alpha = melt_dependent_alpha(alpha_rock, alpha_melt, phi)

        stokes, info = solve_ve_3d(
            stokes, pt_stokes, geometry, flow_bc, rho_g3, G, K, dt,
            iter_max=100_000, nout=500, alpha_dT=alpha * dT,
        )
        stokes = stokes.replace(P0=stokes.P)

    return stokes, thermal, phi, info, chamber
