"""3D visco-elasto-plastic shear bands around a spherical weak inclusion
(reference miniapps/benchmarks/stokes3D/shear_band/ShearBand3D.jl).

Unit box under pure shear (ε̇bg·x, −ε̇bg·z), spherical inclusion of radius
0.1 with η/10 and G/2, Drucker-Prager plasticity C = τ_y = 1.6, φ = 30°,
ψ = 0, η_reg = 1.25e-2, dt = η0/G0/8 (ShearBand3D.jl:55-67). Before yield
the stress follows the Maxwell buildup 2ε̇η(1−exp(−G t/η)); after yield it
is capped near the DP envelope and plastic strain localizes in conical
bands through the inclusion.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stokes3d import tensor_invariant_staggered_3d
from justrelax_tpu.rheology.materials import Material, MaterialStack
from justrelax_tpu.rheology.phases import phase_ratios_from_field
from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d


def setup(n=16, eps_bg=1.0, dtype=None):
    """The problem at ``n``³ cells: the positional arguments ``(stokes,
    pt_stokes, geometry, flow_bc, material, pr_center, pr_edges, dt)`` of
    :func:`solve_vep_3d`, with the initial pure-shear velocity set.

    ``n = (nx, ny, nz)`` gives a box of ``(1, ny/nx, nz/nx)`` with cubic
    cells and the inclusion at its centre (a domain decomposed over an
    uneven device mesh)."""
    ni = (n,) * 3 if isinstance(n, int) else tuple(n)
    li = tuple(k / ni[0] for k in ni)
    geometry = Geometry(ni, li)
    tau_y, phi = 1.6, 30.0
    eta0, G0 = 1.0, 1.0
    Gi = G0 / 2.0
    eta_reg = 1.25e-2
    dt = eta0 / G0 / 8.0
    # reference: C = τ_y directly (cohesion already folds cosφ there since
    # do_DP toggles; we pass C so that C·cosφ = τ_y like the 2D twin)
    C = tau_y / math.cos(math.radians(phi))
    common = dict(
        rho0=0.0, Kb=jnp.inf, is_plastic=1.0, C=C,
        friction_angle=phi, dilation_angle=0.0, eta_reg=eta_reg,
    )
    material = MaterialStack.make([
        Material(G=G0, eta0=eta0, **common),
        Material(G=Gi, eta0=eta0 / 10.0, **common),
    ])

    # spherical inclusion phase field at centers → all staggered ratios
    X, Y, Z = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
    cx, cy, cz = (0.5 * l for l in li)
    inside = (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 <= 0.1**2
    pr = phase_ratios_from_field(jnp.asarray(inside.astype(int)), 2)

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    eta_c = jnp.where(jnp.asarray(inside), eta0 / 10.0, eta0).astype(dt_f)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta_c))

    xv = jnp.asarray(geometry.xvi[0], dt_f)
    zv = jnp.asarray(geometry.xvi[2], dt_f)
    nx, ny, nz = ni
    Vx = jnp.broadcast_to((eps_bg * xv)[:, None, None],
                          (nx + 1, ny + 2, nz + 2))
    Vy = jnp.zeros((nx + 2, ny + 1, nz + 2), dt_f)
    Vz = jnp.broadcast_to((-eps_bg * zv)[None, None, :],
                          (nx + 2, ny + 2, nz + 1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1),
        eps_rel=1.0e-6, eps_abs=1.0e-6,
    )
    return (stokes, pt, geometry, bc, material, pr.center,
            (pr.edge_yz, pr.edge_xz, pr.edge_xy), dt)


def run(n=16, nt=8, eps_bg=1.0, dtype=None, on_step=None):
    """``nt`` loading steps; ``on_step(stokes=, info=, pt=)``, if given, is
    called after each solve."""
    stokes, pt, geometry, bc, material, pr_c, pr_e, dt = setup(
        n, eps_bg, dtype)
    eta0, G0 = 1.0, 1.0  # as in setup()

    t = 0.0
    tau_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep_3d(
            stokes, pt, geometry, bc, material, pr_c, pr_e, dt,
            iter_max=30_000, iter_min=100, nout=200,
            viscosity_relaxation=1.0,
        )
        if on_step is not None:
            on_step(stokes=stokes, info=info, pt=pt)
        t += dt
        tau_II = tensor_invariant_staggered_3d(
            stokes.tau.xx, stokes.tau.yy, stokes.tau.zz,
            stokes.tau.yz, stokes.tau.xz, stokes.tau.xy,
        )
        tau_hist.append(float(tau_II.max()))
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    return stokes, info, tau_hist, sol_hist


def run_multi(n=16, nt=6, eps_bg=1.0, dtype=None):
    """Five weak inclusions under pure shear (reference
    miniapps/benchmarks/stokes3D/shear_band/MultipleInclusions3D.jl:22-175):
    four spheres of radius 0.075 plus a central one of radius 0.1, all with
    G/2 and the SAME viscosity as the background (only the elasticity is
    perturbed — the script defines visc_inc = η0/10 but its phase-2
    composite uses `visc`, MultipleInclusions3D.jl:87-112), DP plasticity,
    dt = η0/G0/8, free-slip box. Shear bands link the inclusions; τ_xx
    follows the Maxwell buildup until the DP cap."""
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    tau_y, phi = 1.6, 30.0
    eta0, G0 = 1.0, 1.0
    Gi = G0 / 2.0
    eta_reg = 1.25e-2
    dt = eta0 / G0 / 8.0  # MultipleInclusions3D.jl:84-85 (1/4 then /= 2)
    C = tau_y / math.cos(math.radians(phi))
    common = dict(
        rho0=0.0, Kb=jnp.inf, is_plastic=1.0, C=C,
        friction_angle=phi, dilation_angle=0.0, eta_reg=eta_reg,
    )
    material = MaterialStack.make([
        Material(G=G0, eta0=eta0, **common),
        Material(G=Gi, eta0=eta0, **common),
    ])

    radii = (0.075, 0.075, 0.075, 0.075, 0.1)
    centers = ((0.4, 0.25, 0.25), (0.25, 0.6, 0.25), (0.25, 0.85, 0.75),
               (0.75, 0.35, 0.75), (0.5, 0.5, 0.5))
    X, Y, Z = np.meshgrid(*[np.asarray(c) for c in geometry.xci], indexing="ij")
    inside = np.zeros(ni, bool)
    for (cx, cy, cz), rad in zip(centers, radii):
        inside |= (X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2 < rad**2
    pr = phase_ratios_from_field(jnp.asarray(inside.astype(int)), 2)

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.full(ni, eta0, dt_f))
    )
    xv = jnp.asarray(geometry.xvi[0], dt_f)
    zv = jnp.asarray(geometry.xvi[2], dt_f)
    Vx = jnp.broadcast_to((eps_bg * xv)[:, None, None], (n + 1, n + 2, n + 2))
    Vy = jnp.zeros((n + 2, n + 1, n + 2), dt_f)
    Vz = jnp.broadcast_to((-eps_bg * zv)[None, None, :], (n + 2, n + 2, n + 1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1),
        eps_rel=1.0e-5, eps_abs=1.0e-5,
    )

    t = 0.0
    tau_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep_3d(
            stokes, pt, geometry, bc, material, pr.center,
            (pr.edge_yz, pr.edge_xz, pr.edge_xy), dt,
            iter_max=30_000, iter_min=100, nout=200,
            viscosity_relaxation=1.0,
        )
        t += dt
        tau_hist.append(float(stokes.tau.xx.max()))
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    return stokes, info, tau_hist, sol_hist
