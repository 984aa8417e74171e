"""2D visco-elasto-plastic shear band benchmark
(reference miniapps/benchmarks/stokes2D/shear_band + test_shearband2D.jl).

Unit box under pure shear (ε̇bg = 1) with a weak circular inclusion (softer
shear modulus) and regularized Drucker-Prager plasticity
(C = 1.6/cos30°, φ=30°, ψ=0, η_vp=8e-3) on a Maxwell VE background
(η0 = G0 = 1, Kb = 4, dt = Maxwell time / 4). 10 timesteps.

Golden values (test_shearband2D.jl:197-201):
  extrema(τII) ≈ (1.4979764502419675, 1.6448491195234836)  atol 1e-3
  max(τxx) at last step ≈ 1.6392450041641278               atol 1e-4
  analytic unyielded VE curve 2εη(1−e^{−Gt/η}) = 1.8358    atol 1e-4
  final residual < 1e-6
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stokes import tensor_invariant_staggered_2d
from justrelax_tpu.rheology.materials import Material, MaterialStack
from justrelax_tpu.solvers.stokes2d_vep import solve_vep


def _circle_phase_ratios(xs, ys, origin, radius):
    """One-hot (…, 2) phase ratios: phase 0 outside the circle, 1 inside."""
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    inside = (X - origin[0]) ** 2 + (Y - origin[1]) ** 2 <= radius**2
    ratios = np.zeros(X.shape + (2,))
    ratios[..., 0] = ~inside
    ratios[..., 1] = inside
    return ratios


def setup(n=32, eps_bg=1.0, dtype=None, dilation_angle=0.0, dqdtau_alt=0.0):
    """The velocity-driven problem at ``n``² cells: the positional arguments
    ``(stokes, pt_stokes, geometry, flow_bc, material, pr_center, pr_vertex,
    dt)`` of :func:`solve_vep`, with the initial pure-shear velocity set."""
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi

    tau_y = 1.6
    phi = 30.0
    eta0, G0 = 1.0, 1.0
    Gi = G0 / (6.0 - 4.0)
    eta_reg = 8.0e-3
    dt = eta0 / G0 / 4.0
    C = tau_y / math.cos(math.radians(phi))

    common = dict(
        rho0=0.0,
        Kb=4.0,
        eta0=eta0,
        is_plastic=1.0,
        C=C,
        friction_angle=phi,
        dilation_angle=dilation_angle,
        eta_reg=eta_reg,
        dqdtau_alt=dqdtau_alt,
    )
    material = MaterialStack.make(
        [Material(G=G0, **common), Material(G=Gi, **common)]
    )

    radius = 0.1
    pr_center = jnp.asarray(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), radius))
    pr_vertex = jnp.asarray(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), radius))

    stokes = StokesState.make(ni, dtype=dtype)
    dt_f = stokes.P.dtype
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1)
    )

    # initial pure-shear velocity on the FULL arrays (test_shearband2D.jl:146-147)
    xv = jnp.asarray(xvi[0], dt_f)
    yv = jnp.asarray(xvi[1], dt_f)
    Vx = jnp.broadcast_to((eps_bg * xv)[:, None], (n + 1, n + 2))
    Vy = jnp.broadcast_to((-eps_bg * yv)[None, :], (n + 2, n + 1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))
    return (stokes, pt_stokes, geometry, flow_bc, material, pr_center,
            pr_vertex, dt)


def run(n=32, nt=10, eps_bg=1.0, dtype=None, displacement_driven=False,
        dilation_angle=0.0, dqdtau_alt=0.0,
        visc_plastic_tau=False, on_step=None):
    """``displacement_driven=True`` reproduces the strain-increment variant
    (reference ShearBand2D_strain_increment.jl): the boundary forcing is set
    as a displacement increment U = V·dt under
    ``DisplacementBoundaryConditions`` and converted at solve entry — with a
    fixed dt the two formulations are algebraically identical (see
    ops/displacement.py). ``dilation_angle`` > 0 activates the volumetric
    plastic path (ε_vol_pl, EVol_pl) exercised by the reference DPCap test
    (test_shearband2D_DPCap.jl:186-202). ``on_step(stokes=, info=, pt=)``,
    if given, is called after each solve."""
    from justrelax_tpu.ops.bc import DisplacementBoundaryConditions
    from justrelax_tpu.ops.displacement import (
        displacement2velocity,
        velocity2displacement,
    )

    (stokes, pt_stokes, geometry, flow_bc, material, pr_center, pr_vertex,
     dt) = setup(n, eps_bg, dtype, dilation_angle, dqdtau_alt)
    eta0, G0 = 1.0, 1.0  # as in setup()
    if displacement_driven:
        flow_bc = DisplacementBoundaryConditions(
            free_slip=Faces(left=True, right=True, top=True, bot=True)
        )
        Ux, Uy = flow_bcs((stokes.V.Vx * dt, stokes.V.Vy * dt), flow_bc)
        stokes = stokes.replace(U=stokes.U.replace(Ux=Ux, Uy=Uy))
        stokes = displacement2velocity(stokes, dt, flow_bc)

    t = 0.0
    tau_max_hist, sol_hist, tt = [], [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes,
            pt_stokes,
            geometry,
            flow_bc,
            material,
            pr_center,
            pr_vertex,
            dt,
            iter_max=50_000,
            nout=100,
            visc_plastic_tau=visc_plastic_tau,
        )
        if on_step is not None:
            on_step(stokes=stokes, info=info, pt=pt_stokes)
        if displacement_driven:
            stokes = velocity2displacement(stokes, dt)
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
        tt.append(t)

    tau_II = tensor_invariant_staggered_2d(stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    return stokes, info, tau_max_hist, sol_hist, tau_II


def run_softening(n=32, nt=5, eps_bg=1.0):
    """Nonlinear-cohesion-softening shear band
    (reference test_shearband2D_softening.jl:63-206): the base shearband with
    ``soft_C = NonLinearSoftening(ξ₀=τ_y, Δ=τ_y/2)`` on both phases and
    dt = Maxwell/4/5 over 5 steps. Goldens (:201-205):
      max(τxx) at last step ≈ 0.466   atol 1e-3
      analytic VE curve at t=0.25 ≈ 0.4423  atol 1e-4
      final residual < 1e-6
    (At t = 0.25 the stress is far below yield, so the goldens pin the
    softened-plasticity plumbing on the elastic loading path.)"""
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi

    tau_y = 1.6
    phi = 30.0
    eta0, G0 = 1.0, 1.0
    Gi = G0 / (6.0 - 4.0)
    eta_reg = 8.0e-3
    dt = eta0 / G0 / 4.0 / 5.0
    C = tau_y / math.cos(math.radians(phi))

    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0, C=C,
        friction_angle=phi, eta_reg=eta_reg,
        # GeoParams NonLinearSoftening(ξ₀=τ_y, Δ=τ_y/2) (:99)
        soft_C_nl=1.0, soft_C_nl_xi0=tau_y, soft_C_nl_delta=tau_y / 2.0,
    )
    material = MaterialStack.make(
        [Material(G=G0, **common), Material(G=Gi, **common)]
    )

    radius = 0.1
    pr_center = jnp.asarray(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), radius))
    pr_vertex = jnp.asarray(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), radius))

    stokes = StokesState.make(ni)
    dt_f = stokes.P.dtype
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, CFL=0.75 / math.sqrt(2.1)
    )
    xv = jnp.asarray(xvi[0], dt_f)
    yv = jnp.asarray(xvi[1], dt_f)
    Vx = jnp.broadcast_to((eps_bg * xv)[:, None], (n + 1, n + 2))
    Vy = jnp.broadcast_to((-eps_bg * yv)[None, :], (n + 2, n + 1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    t = 0.0
    tau_max_hist, sol_hist = [], []
    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material,
            pr_center, pr_vertex, dt, iter_max=50_000, nout=100,
        )
        tau_max_hist.append(float(stokes.tau.xx.max()))
        t += dt
        sol_hist.append(2.0 * eps_bg * eta0 * (1.0 - math.exp(-G0 * t / eta0)))
    return stokes, info, tau_max_hist, sol_hist


def run_dpcap(n=32, nt=10):
    """Dilatant Drucker-Prager(-Cap) shear band
    (reference test_shearband2D_DPCap.jl:59-202): ψ = 3° activates the
    volumetric plastic path (ε_vol_pl = −λ·∂Q/∂P ≥ 0, EVol_pl accumulation).
    The reference checks an envelope (:189-201): convergence < 1e-5,
    τII_max finite and < 2, ε_pl_max > 0, EVol_max > 0, ε_vol_pl ≥ 0.
    The tension cap (pT = −0.5) is what brings yield into reach in this
    scenario — the plain cone never yields in 10 steps (τII_max ≈ 1.46 <
    C·cosϕ + P·sinϕ); see plasticity._tension_cap_yield."""
    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi

    tau_y = 1.6
    phi, psi = 30.0, 3.0
    eta0, G0 = 1.0, 1.0
    Gi = G0 / 2.0
    eta_reg = 1.0e-3
    dt = eta0 / G0 / 8.0
    C = tau_y / math.cos(math.radians(phi))

    common = dict(
        rho0=0.0, Kb=4.0, eta0=eta0, is_plastic=1.0, C=C,
        friction_angle=phi, dilation_angle=psi, eta_reg=eta_reg,
        tension_pT=-0.5,
    )
    material = MaterialStack.make(
        [Material(G=G0, **common), Material(G=Gi, **common)]
    )

    radius = 0.1
    pr_center = jnp.asarray(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), radius))
    pr_vertex = jnp.asarray(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), radius))

    stokes = StokesState.make(ni)
    dt_f = stokes.P.dtype
    pt_stokes = PTStokesCoeffs.make(
        geometry.li, geometry.di,
        eps_abs=1.0e-6, eps_rel=1.0e-6, CFL=0.95 / math.sqrt(2.1),
    )
    xv = jnp.asarray(xvi[0], dt_f)
    yv = jnp.asarray(xvi[1], dt_f)
    Vx = jnp.broadcast_to(xv[:, None], (n + 1, n + 2))
    Vy = jnp.broadcast_to((-yv)[None, :], (n + 2, n + 1))
    flow_bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))

    info = None
    for _ in range(nt):
        stokes, info = solve_vep(
            stokes, pt_stokes, geometry, flow_bc, material,
            pr_center, pr_vertex, dt, iter_max=50_000, nout=1000,
        )
    tau_II = tensor_invariant_staggered_2d(stokes.tau.xx, stokes.tau.yy, stokes.tau.xy)
    return stokes, info, tau_II
