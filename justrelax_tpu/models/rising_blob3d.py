"""Rising blob 3D: particle-tracked buoyant sphere in a viscous mantle
(reference miniapps/convection/RisingBlob3D — the capstone integration of
the 3D PIC transport with the 3D Stokes solver).

A light sphere (Δρ < 0) is carried by particles; each step: phase ratios
from particles → buoyancy → VE 3D Stokes solve → RK2 particle advection →
re-slotting → injection. The blob rises with a Stokes-velocity-scale speed
and stays coherent.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu.particles.particles3d import (
    advect_rk2_3d,
    inject_particles_3d,
    init_particles_3d,
    move_particles_3d,
    particle2centroid_3d,
    phase_ratios_from_particles_3d,
)
from justrelax_tpu.solvers.stokes3d import solve_ve_3d
from justrelax_tpu.utils.timestep import compute_dt

MANTLE, BLOB = 0, 1


def run(n=16, nt=4, d_rho=-100.0, eta0=1.0e21, R=0.12, dtype=None, seed=0):
    L = 1.0e6  # 1000 km box
    ni = (n, n, n)
    geometry = Geometry(ni, (L, L, L))
    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype

    particles = init_particles_3d(
        geometry, nxcell=8, max_xcell=20, min_xcell=4, seed=seed
    )
    blob0 = (
        (np.asarray(particles.px) - 0.5 * L) ** 2
        + (np.asarray(particles.py) - 0.5 * L) ** 2
        + (np.asarray(particles.pz) - 0.3 * L) ** 2
    ) < (R * L) ** 2
    p_phase = jnp.asarray(blob0.astype(float))

    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.full(ni, eta0, dt_f))
    )
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, CFL=0.9 / math.sqrt(3.1)
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    zeros = jnp.zeros(ni, dt_f)
    G = jnp.full(ni, jnp.inf, dt_f)
    K = jnp.asarray(jnp.inf, dt_f)
    g = 9.81
    rho_m = 3.3e3

    info = None
    zc_hist = []
    for _ in range(nt):
        center, _ = phase_ratios_from_particles_3d(
            particles, p_phase, 2, geometry
        )
        rho = rho_m + d_rho * center[..., BLOB]
        # positive ρg ⇒ gravity along −z
        stokes, info = solve_ve_3d(
            stokes, pt, geometry, bc, (zeros, zeros, jnp.asarray(rho * g, dt_f)),
            G, K, jnp.inf, iter_max=20_000, nout=500,
        )
        dt = float(compute_dt(stokes.V.components, geometry.di))

        particles = advect_rk2_3d(
            particles, (stokes.V.Vx, stokes.V.Vy, stokes.V.Vz), geometry, dt
        )
        particles, f = move_particles_3d(particles, geometry, {"phase": p_phase})
        particles, f = inject_particles_3d(
            particles, geometry, {}, phases=2, fields=f
        )
        p_phase = f["phase"]

        a = np.asarray(particles.active) & (np.asarray(p_phase) > 0.5)
        zc_hist.append(float(np.asarray(particles.pz)[a].mean()))
    return stokes, particles, p_phase, info, zc_hist
