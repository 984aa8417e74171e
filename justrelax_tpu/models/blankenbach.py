"""Blankenbach thermal convection benchmark (Ra = 1e4, case 1).

Reference: test/test_Blankenbach.jl + miniapps/benchmarks/stokes2D/
Blankenbach2D — a 1000 km square box, linear geotherm 273→1273 K with a +20 K
rectangular anomaly near the left wall at 600 km depth, PT_Density
(ρ0=4000, α=2.5e-5), η=1e23, k=5, Cp=1250, g=10 (Ra = 1e4). Coupled loop:
VEP Stokes (viscous limit) → CFL dt → PT thermal diffusion → temperature
advection. The reference advects T with particles; this model uses WENO-5
advection at cell centers (cf. reference test_WENO5.jl:262-266) — both hit
the Nusselt/velocity diagnostics within the test tolerances.

Golden values at 32², 10 steps (test_Blankenbach.jl:285-287):
  Urms ≈ 0.40987052065118357 (rtol 1e-1)
  Nu_top ≈ 1.0026242251320245 (rtol 1e-2), residual < 1e-4
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.advection.weno5 import weno_advect
from justrelax_tpu.core.coeffs import PTStokesCoeffs, PTThermalCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState, ThermalState
from justrelax_tpu.ops.bc import (
    Faces,
    TemperatureBoundaryConditions,
    VelocityBoundaryConditions,
    thermal_bcs,
)
from justrelax_tpu.ops.interpolation import velocity2center, velocity2vertex
from justrelax_tpu.rheology.materials import Material
from justrelax_tpu.solvers.stokes2d_vep import solve_vep
from justrelax_tpu.solvers.thermal import heatdiffusion_PT
from justrelax_tpu.utils.timestep import compute_dt


def run(nx=32, ny=32, nit=10, dtype=None):
    ni = (nx, ny)
    ly = 1000.0e3
    lx = ly
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci, xvi = geometry.xci, geometry.xvi
    di = geometry.di

    rho0, Cp0, k0, eta0, g = 4000.0, 1250.0, 5.0, 1.0e23, 10.0
    material = Material(
        rho0=rho0, T0=273.0, alpha=2.5e-5, beta=0.0,
        Cp=Cp0, k=k0, eta0=eta0, gravity=g,
    )
    kappa = k0 / (Cp0 * rho0)
    dt_diff = 0.9 * min(di) ** 2 / kappa / 4.0

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(
            eta=jnp.full(ni, eta0, dt_f),
            eta_v=jnp.full((nx + 1, ny + 1), eta0, dt_f),
        )
    )
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-4, CFL=1.0 / math.sqrt(2.1)
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    # temperature profile + rectangular anomaly
    thermal = ThermalState.make(ni, dtype=dtype)
    dTdZ = (1273.0 - 273.0) / ly
    T = np.zeros((nx + 2, ny + 2))
    T[:, 1:-1] = (-xci[1])[None, :] * dTdZ + 273.0
    xc_a, yc_a, r_a = 0.0, -600.0e3, 100.0e3
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    mask = ((X - xc_a) ** 2 <= r_a**2) & ((Y - yc_a) ** 2 <= r_a**2)
    T[1:-1, 1:-1] += 20.0 * mask
    Tbot = float(-xvi[1][0] * dTdZ + 273.0)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=273.0, bot=Tbot),
    )
    Tj = thermal_bcs(jnp.asarray(T, dt_f), thermal_bc)
    thermal = thermal.replace(T=Tj, Told=Tj)

    Urms_hist, Nu_hist = [], []
    info = None
    for _ in range(nit):
        T_center = thermal.T[1:-1, 1:-1]
        stokes, info = solve_vep(
            stokes,
            pt_stokes,
            geometry,
            flow_bc,
            material,
            None,  # single phase
            None,
            jnp.inf,
            T=T_center,
            iter_max=150_000,
            nout=200,
        )
        dt = float(compute_dt(stokes.V.components, di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, thermal.T[1:-1, 1:-1], stokes.P, dt, di, geometry.li,
            eps=1.0e-5, CFL=0.99 / math.sqrt(2.1),
        )
        thermal, _ = heatdiffusion_PT(
            thermal,
            pt_thermal,
            thermal_bc,
            dt,
            geometry,
            material=material,
            P=stokes.P,
            iter_max=10_000,
            nout=100,
        )

        # Nusselt number at the top (reference :236-240)
        dT_top = jnp.abs(thermal.T[1:-1, -1] - thermal.T[1:-1, -2]) / di[1]
        Nu_hist.append(float((ly / (1000.0 * lx)) * jnp.sum(dT_top * di[0])))

        # rms velocity (reference :244-253)
        Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
        vmag2 = Vx_v**2 + Vy_v**2
        Urms_hist.append(
            float(
                jnp.sqrt(jnp.sum(vmag2 * di[0] * di[1]) / lx / ly)
                * (ly * rho0 * Cp0 / k0)
            )
        )

        # WENO-5 temperature advection at cell centers (no vertex roundtrip:
        # the reference's center→vertex→center interpolation smooths T, which
        # is harmless for its convergence-only oracle but corrupts Nu)
        Vx_c, Vy_c = velocity2center(stokes.V.Vx, stokes.V.Vy)
        Tc = weno_advect(thermal.T[1:-1, 1:-1], (Vx_c, Vy_c), di, dt)
        T_new = thermal.T.at[1:-1, 1:-1].set(Tc)
        T_new = thermal_bcs(T_new, thermal_bc)
        thermal = thermal.replace(T=T_new)

    return Urms_hist, Nu_hist, info, stokes, thermal


def run_particles(nx=32, ny=32, nit=10, dtype=None, seed=0, on_step=None):
    """The reference's ACTUAL transport scheme: particles carry T, relaxed
    toward the grid solution by subgrid diffusion, advected with RK2, and
    interpolated back to centroids (test_Blankenbach.jl:100-260 — per step:
    solve! → compute_dt → heatdiffusion_PT! → subgrid_characteristic_time! +
    subgrid_diffusion_centroid! → advection!/move!/inject! → diagnostics →
    particle2centroid! → thermal.T). Same Urms/Nu goldens as :func:`run`,
    pinning the PIC stack (P2G/G2P, subgrid diffusion, injection) to a
    reference thermal-convection oracle. ``on_step(stokes=, info=, pt=,
    thermal=, thermal_info=, pt_thermal=)``, if given, is called at the end
    of each step."""
    from justrelax_tpu.particles.particles import (
        advect_rk2,
        centroid2particle,
        init_particles,
        inject_particles,
        move_particles,
        particle2centroid,
        subgrid_characteristic_time,
        subgrid_diffusion,
    )

    ni = (nx, ny)
    ly = 1000.0e3
    lx = ly
    geometry = Geometry(ni, (lx, ly), origin=(0.0, -ly))
    xci, xvi = geometry.xci, geometry.xvi
    di = geometry.di

    rho0, Cp0, k0, eta0, g = 4000.0, 1250.0, 5.0, 1.0e23, 10.0
    material = Material(
        rho0=rho0, T0=273.0, alpha=2.5e-5, beta=0.0,
        Cp=Cp0, k=k0, eta0=eta0, gravity=g,
    )
    kappa = k0 / (Cp0 * rho0)
    dt_diff = 0.9 * min(di) ** 2 / kappa / 4.0

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(
            eta=jnp.full(ni, eta0, dt_f),
            eta_v=jnp.full((nx + 1, ny + 1), eta0, dt_f),
        )
    )
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-4, CFL=1.0 / math.sqrt(2.1)
    )
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    thermal = ThermalState.make(ni, dtype=dtype)
    dTdZ = (1273.0 - 273.0) / ly
    T = np.zeros((nx + 2, ny + 2))
    T[:, 1:-1] = (-xci[1])[None, :] * dTdZ + 273.0
    xc_a, yc_a, r_a = 0.0, -600.0e3, 100.0e3
    X, Y = np.meshgrid(xci[0], xci[1], indexing="ij")
    mask = ((X - xc_a) ** 2 <= r_a**2) & ((Y - yc_a) ** 2 <= r_a**2)
    T[1:-1, 1:-1] += 20.0 * mask
    Tbot = float(-xvi[1][0] * dTdZ + 273.0)
    thermal_bc = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=273.0, bot=Tbot),
    )
    Tj = thermal_bcs(jnp.asarray(T, dt_f), thermal_bc)
    thermal = thermal.replace(T=Tj, Told=Tj)

    # particles carrying T (reference: 24/36/12 per cell)
    particles = init_particles(geometry, nxcell=24, max_xcell=36, min_xcell=12,
                               seed=seed)
    pT = centroid2particle(thermal.T, particles, geometry)  # ghosted lattice
    p_phase = jnp.zeros_like(particles.px)  # single phase

    Urms_hist, Nu_hist = [], []
    info = None
    for _ in range(nit):
        T_center = thermal.T[1:-1, 1:-1]
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material, None, None,
            jnp.inf, T=T_center,
            iter_max=150_000, nout=200,
        )
        dt = float(compute_dt(stokes.V.components, di, dt_diff))

        pt_thermal = PTThermalCoeffs.from_material(
            material, T_center, stokes.P, dt, di, geometry.li,
            eps=1.0e-5, CFL=0.99 / math.sqrt(2.1),
        )
        thermal, thermal_info = heatdiffusion_PT(
            thermal, pt_thermal, thermal_bc, dt, geometry,
            material=material, P=stokes.P, iter_max=10_000, nout=100,
        )

        # subgrid relaxation of the particle temperature toward the grid
        dt0 = subgrid_characteristic_time(
            material, T_center, stokes.P, None, di
        )
        pT = subgrid_diffusion(
            pT, thermal.T, thermal.dT, dt0, particles, geometry, dt,
        )

        # advect + rebin + inject
        V = (stokes.V.Vx, stokes.V.Vy)
        particles = advect_rk2(particles, V, geometry, dt)
        fields = {"phase": p_phase, "T": pT}
        particles, fields = move_particles(particles, geometry, fields)
        particles, fields = inject_particles(
            particles, geometry,
            fields_from_centers={"T": thermal.T[1:-1, 1:-1]},
            phases=jnp.zeros(ni, jnp.float64), fields=fields,
        )
        p_phase, pT = fields["phase"], fields["T"]

        dT_top = jnp.abs(thermal.T[1:-1, -1] - thermal.T[1:-1, -2]) / di[1]
        Nu_hist.append(float((ly / (1000.0 * lx)) * jnp.sum(dT_top * di[0])))
        Vx_v, Vy_v = velocity2vertex(stokes.V.Vx, stokes.V.Vy)
        vmag2 = Vx_v**2 + Vy_v**2
        Urms_hist.append(
            float(
                jnp.sqrt(jnp.sum(vmag2 * di[0] * di[1]) / lx / ly)
                * (ly * rho0 * Cp0 / k0)
            )
        )

        # particles → grid temperature closes the step
        T_cc = particle2centroid(pT, particles, geometry)
        T_new = thermal_bcs(thermal.T.at[1:-1, 1:-1].set(T_cc), thermal_bc)
        thermal = thermal.replace(T=T_new)
        if on_step is not None:
            on_step(stokes=stokes, info=info, pt=pt_stokes, thermal=thermal,
                    thermal_info=thermal_info, pt_thermal=pt_thermal)

    return Urms_hist, Nu_hist, info, stokes, thermal
