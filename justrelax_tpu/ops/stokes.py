"""Stokes stencil kernels (2D): divergence, strain rate, pressure, stress,
velocity update, residuals.

Vectorized equivalents of the reference sweeps
(/root/reference/src/stokes/VelocityKernels.jl, PressureKernels.jl,
StressKernels.jl). All functions are pure array→array; shapes follow the
staggered layout documented in core/state.py. 3D twins live in stokes3d.py.

The damped PT updates (Räss et al. 2022):
  P  ← P + ψ·RP/(1+ψ/(K dt)),  ψ = (1/η + 1/(G dt))⁻¹ · r/θ_dτ
  τ  ← τ + (2η ε − (τ−τ_o)·η/(G dt) − τ) / (θ_dτ + η/(G dt) + 1)
  V  ← V + (∇·τ − ∇P − ρg) · ηdτ / ητ̄
"""

from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp

from justrelax_tpu.ops.stencil import av_a

Array = Any

__all__ = [
    "compute_grad_V",
    "compute_strain_rate",
    "compute_P",
    "compute_tau_visc",
    "compute_tau_ve",
    "compute_V",
    "compute_Res",
    "tensor_invariant_2d",
    "compute_vorticity",
]


# Spacing families (reference _di.center/_di.vertex named spacings,
# src/grid/Grid.jl): derivatives landing at CENTERS divide by the cell width
# (center family, inv_dx/inv_dy); derivatives landing at FACES/VERTICES
# divide by the distance between adjacent centers (vertex family,
# inv_dx_v/inv_dy_v). On a uniform grid both coincide, so the vertex-family
# arguments default to the center ones; a NonuniformGeometry passes
# broadcastable per-axis arrays for both.


# --- divergence -------------------------------------------------------------
def compute_grad_V(Vx, Vy, inv_dx, inv_dy):
    """∇·V at cell centers (VelocityKernels.jl:3-6)."""
    return (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx + (
        Vy[1:-1, 1:] - Vy[1:-1, :-1]
    ) * inv_dy


# --- deviatoric strain rate -------------------------------------------------
def compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy, inv_dx_v=None, inv_dy_v=None):
    """(εxx, εyy) at centers, εxy at vertices (VelocityKernels.jl:10-44)."""
    inv_dx_v = inv_dx if inv_dx_v is None else inv_dx_v
    inv_dy_v = inv_dy if inv_dy_v is None else inv_dy_v
    third = 1.0 / 3.0
    exx = (Vx[1:, 1:-1] - Vx[:-1, 1:-1]) * inv_dx - grad_V * third
    eyy = (Vy[1:-1, 1:] - Vy[1:-1, :-1]) * inv_dy - grad_V * third
    exy = 0.5 * (
        (Vx[:, 1:] - Vx[:, :-1]) * inv_dy_v + (Vy[1:, :] - Vy[:-1, :]) * inv_dx_v
    )
    return exx, eyy, exy


# --- pressure ---------------------------------------------------------------
def compute_P(P, P0, grad_V, Q, eta, K, G, dt, r, theta_dtau, alpha_dT=None):
    """Compressible visco-elastic pressure update (PressureKernels.jl:186-206).

    ``K``/``G`` may be ∞ (incompressible / purely viscous). With
    ``alpha_dT = α·ΔT`` the thermal-stress source of Kiss et al. (2023) is
    added (reference _compute_P! variant at PressureKernels.jl:197-206).
    Returns (RP, P).
    """
    _Kdt = 1.0 / (K * dt)
    _Gdt = 1.0 / (G * dt)
    _dt = 1.0 / dt
    rhs = -grad_V + Q * _dt
    if alpha_dT is not None:
        rhs = rhs + alpha_dT * _dt
    RP = -(P - P0) * _Kdt + rhs
    psi = 1.0 / (1.0 / eta + _Gdt) * (r / theta_dtau)
    P_new = ((P0 * _Kdt + rhs) * psi + P) / (1.0 + _Kdt * psi)
    return RP, P_new


# --- deviatoric stress ------------------------------------------------------
def _dtau_r(theta_dtau, eta, _Gdt):
    return 1.0 / (theta_dtau + eta * _Gdt + 1.0)


def _stress_increment(tau, tau_o, eta, eps, _Gdt, dtau_r):
    """dτ = dτ_r · (2η ε − (τ−τ_o)·η/(G dt) − τ)  (StressKernels.jl:2-16)."""
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def compute_tau_visc(txx, tyy, txy, exx, eyy, exy, eta, theta_dtau):
    """Purely viscous PT stress update (StressKernels.jl:34-61)."""
    inf = jnp.inf
    return compute_tau_ve(
        txx,
        tyy,
        txy,
        jnp.zeros_like(txx),
        jnp.zeros_like(tyy),
        jnp.zeros_like(txy),
        exx,
        eyy,
        exy,
        eta,
        jnp.full_like(eta, inf),
        theta_dtau,
        1.0,
    )


def compute_tau_ve(txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy, eta, G,
                   theta_dtau, dt, eta_v=None, G_v=None):
    """Visco-elastic PT stress update: normal components at centers, shear at
    vertices (StressKernels.jl:65-95).

    Serial form (``eta_v``/``G_v`` omitted): shear is updated on interior
    vertices only; boundary vertices of τxy are left untouched (free-slip
    keeps them zero).

    Distributed compute-in-halo form: pass vertex-located ``eta_v``/``G_v``
    covering *all* local vertices (built from ghost-extended center fields,
    see parallel/stokes2d.py) — every vertex of ``txy`` is then updated and
    the caller is responsible for freezing physical-boundary rows
    (``_freeze_rows``), which reproduces the serial untouched-boundary
    semantics exactly.
    """
    _Gdt = 1.0 / (G * dt)
    dtau_r = _dtau_r(theta_dtau, eta, _Gdt)
    txx = txx + _stress_increment(txx, txx_o, eta, exx, _Gdt, dtau_r)
    tyy = tyy + _stress_increment(tyy, tyy_o, eta, eyy, _Gdt, dtau_r)

    if eta_v is not None:
        _Gdt_v = 1.0 / (G_v * dt)
        dtau_r_v = _dtau_r(theta_dtau, eta_v, _Gdt_v)
        txy = txy + _stress_increment(txy, txy_o, eta_v, exy, _Gdt_v, dtau_r_v)
        return txx, tyy, txy

    eta_v = av_a(eta)  # interior vertices (nx-1, ny-1)
    _Gdt_v = 1.0 / (av_a(G) * dt)
    dtau_r_v = _dtau_r(theta_dtau, eta_v, _Gdt_v)
    inc = _stress_increment(
        txy[1:-1, 1:-1], txy_o[1:-1, 1:-1], eta_v, exy[1:-1, 1:-1], _Gdt_v, dtau_r_v
    )
    # pad+add instead of .at[interior].add: a zero-pad fuses into the
    # elementwise add (see ops/stencil.py::interior_add).
    txy = txy + jnp.pad(inc, ((1, 1), (1, 1)))
    return txx, tyy, txy


# --- velocity update --------------------------------------------------------
def _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy, inv_dx_v=None, inv_dy_c=None):
    """∂x momentum balance on x-FACES.

    Serial form: ``P``/``txx``/``rho_gx`` are the (nx, ny) center arrays and
    ``txy`` the full (nx+1, ny+1) vertex array → interior faces (nx-1, ny).
    Distributed compute-in-halo form (parallel/stokes2d.py): the center
    arrays arrive ghost-extended along x (nxl+2, nyl) while ``txy`` is the
    (nxl+1, nyl+1) local vertex block → ALL local faces (nxl+1, nyl); the
    face-row alignment of ``txy`` is detected from the shapes.

    τxx/P differences land on x-faces (vertex family ``inv_dx_v``); τxy
    differences land there too but run along y between VERTICES (center
    family ``inv_dy_c``)."""
    inv_dx_v = inv_dx if inv_dx_v is None else inv_dx_v
    inv_dy_c = inv_dy if inv_dy_c is None else inv_dy_c
    txy_f = txy if txy.shape[0] == P.shape[0] - 1 else txy[1:-1, :]
    d_xa_t = (txx[1:, :] - txx[:-1, :]) * inv_dx_v
    d_yi_t = (txy_f[:, 1:] - txy_f[:, :-1]) * inv_dy_c
    d_xa_P = (P[1:, :] - P[:-1, :]) * inv_dx_v
    f = 0.5 * (rho_gx[1:, :] + rho_gx[:-1, :])
    return d_xa_t + d_yi_t - d_xa_P - f


def _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy, inv_dy_v=None, inv_dx_c=None):
    """∂y momentum balance on y-FACES: interior (nx, ny-1) serial, ALL local
    faces in the distributed ghost-extended form (see ``_x_momentum``)."""
    inv_dy_v = inv_dy if inv_dy_v is None else inv_dy_v
    inv_dx_c = inv_dx if inv_dx_c is None else inv_dx_c
    txy_f = txy if txy.shape[1] == P.shape[1] - 1 else txy[:, 1:-1]
    d_ya_t = (tyy[:, 1:] - tyy[:, :-1]) * inv_dy_v
    d_xi_t = (txy_f[1:, :] - txy_f[:-1, :]) * inv_dx_c
    d_ya_P = (P[:, 1:] - P[:, :-1]) * inv_dy_v
    f = 0.5 * (rho_gy[:, 1:] + rho_gy[:, :-1])
    return d_ya_t + d_xi_t - d_ya_P - f


def compute_V(
    Vx,
    Vy,
    P,
    txx,
    tyy,
    txy,
    etadtau,
    rho_gx,
    rho_gy,
    eta_tau,
    inv_dx,
    inv_dy,
    free_surface_dt: Optional[float] = None,
    spacings=None,
):
    """Damped velocity update on interior nodes (VelocityKernels.jl:108-180).

    With ``free_surface_dt`` set, adds the free-surface stabilization
    correction Vy·∂(ρg_y)/∂y·dt to the y-momentum residual. ``spacings`` is
    an optional nonuniform bundle ``(inv_dx_v, inv_dy_c, inv_dy_v,
    inv_dx_c)`` restricted to interior faces.
    """
    sx = (None, None) if spacings is None else spacings[:2]
    sy = (None, None) if spacings is None else spacings[2:]
    rx = _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy, *sx)
    ry = _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy, *sy)
    if free_surface_dt is not None:
        # ∂ρg/∂y spans adjacent centers → same spacing family as ∂yP
        # (reference nonuniform variant VelocityKernels.jl:157-171)
        fs_inv_dy = inv_dy if spacings is None else spacings[2]
        ry = ry + _free_surface_correction(Vy, rho_gy, fs_inv_dy, free_surface_dt)
    etax = 0.5 * (eta_tau[1:, :] + eta_tau[:-1, :])
    etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
    # pad+add: see compute_tau_ve (avoids the slow misaligned-slab DUS)
    Vx = Vx + jnp.pad(rx * etadtau / etax, ((1, 1), (1, 1)))
    Vy = Vy + jnp.pad(ry * etadtau / etay, ((1, 1), (1, 1)))
    return Vx, Vy


def _free_surface_correction(Vy, rho_gy, inv_dy, dt):
    """Vy·∂(ρg)/∂y·θ·dt on interior Vy nodes (VelocityKernels.jl:158-173)."""
    # interior Vy values: Vy[1:-1, 1:-1] → (nx, ny-1)
    Vy_in = Vy[1:-1, 1:-1]
    # ∂ρg/∂y at the Vy node: (ρg[i, min(j+1, ny)] − ρg[i, j]) / dy, j = 0..ny-2
    drho = (rho_gy[:, 1:] - rho_gy[:, :-1]) * inv_dy
    return Vy_in * drho * dt


def compute_Res(P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy, Vy=None,
                free_surface_dt=None, spacings=None):
    """Momentum residuals Rx (nx-1, ny), Ry (nx, ny-1) (VelocityKernels.jl:246+)."""
    sx = (None, None) if spacings is None else spacings[:2]
    sy = (None, None) if spacings is None else spacings[2:]
    Rx = _x_momentum(P, txx, txy, rho_gx, inv_dx, inv_dy, *sx)
    Ry = _y_momentum(P, tyy, txy, rho_gy, inv_dx, inv_dy, *sy)
    if free_surface_dt is not None:
        fs_inv_dy = inv_dy if spacings is None else spacings[2]
        Ry = Ry + _free_surface_correction(Vy, rho_gy, fs_inv_dy, free_surface_dt)
    return Rx, Ry


# --- diagnostics ------------------------------------------------------------
def tensor_invariant_2d(xx, yy, xy_c):
    """Second invariant at centers (GeoParams convention):
    √(½(xx²+yy²) + xy²)."""
    return jnp.sqrt(0.5 * (xx**2 + yy**2) + xy_c**2)


def tensor_invariant_staggered_2d(xx, yy, xy_v):
    """Staggered second invariant at centers: shear term is the mean of the
    squared 4 surrounding vertex values (reference tensor_invariant!,
    StressKernels.jl:465-476)."""
    xy2 = 0.25 * (
        xy_v[:-1, :-1] ** 2 + xy_v[1:, :-1] ** 2 + xy_v[:-1, 1:] ** 2 + xy_v[1:, 1:] ** 2
    )
    return jnp.sqrt(0.5 * (xx**2 + yy**2) + xy2)


def compute_vorticity(Vx, Vy, inv_dx, inv_dy):
    """ω_xy = ½(∂Vx/∂y − ∂Vy/∂x) at vertices
    (stress_rotation_particles.jl:5-20)."""
    return 0.5 * (
        (Vx[:, 1:] - Vx[:, :-1]) * inv_dy - (Vy[1:, :] - Vy[:-1, :]) * inv_dx
    )
