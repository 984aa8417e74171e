"""Stokes stencil kernels, 3D.

Vectorized equivalents of the reference 3D sweeps
(/root/reference/src/stokes/VelocityKernels.jl:59-242,
StressKernels.jl:148-232). Staggered shapes per core/state.py; axis order
(x, y, z); shear components live on cell edges:
εyz/τyz (nx, ny+1, nz+1), εxz/τxz (nx+1, ny, nz+1), εxy/τxy (nx+1, ny+1, nz).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

Array = Any

__all__ = [
    "compute_grad_V_3d",
    "compute_strain_rate_3d",
    "compute_tau_ve_3d",
    "compute_V_3d",
    "spacing_families_3d",
    "tensor_invariant_staggered_3d",
]


def spacing_families_3d(geometry):
    """``(inv_di, inv_di_v, mom_spacings)`` for the 3D kernels.

    Uniform grids: ``(scalar reciprocals, None, None)``. Nonuniform grids
    (``NonuniformGeometry``, reference Grid.jl:262-316): per-axis
    broadcastable reciprocal arrays of the center family (cell widths), the
    vertex family (center-to-center distances, boundary-clamped), and the
    momentum bundle ``(interior vertex family, center family)`` for
    :func:`compute_V_3d`."""
    if not hasattr(geometry, "di_center"):
        return tuple(1.0 / d for d in geometry.di), None, None

    def _b(vec, axis):
        a = jnp.asarray(vec)
        shape = [1, 1, 1]
        shape[axis] = a.shape[0]
        return a.reshape(shape)

    inv_dc = tuple(1.0 / _b(geometry.di_center[d], d) for d in range(3))
    inv_dv = tuple(1.0 / _b(geometry.di_vertex[d], d) for d in range(3))
    inv_dv_in = tuple(
        1.0 / _b(jnp.asarray(geometry.di_vertex[d])[1:-1], d) for d in range(3)
    )
    return inv_dc, inv_dv, (inv_dv_in, inv_dc)


def compute_grad_V_3d(Vx, Vy, Vz, inv_di):
    return (
        (Vx[1:, 1:-1, 1:-1] - Vx[:-1, 1:-1, 1:-1]) * inv_di[0]
        + (Vy[1:-1, 1:, 1:-1] - Vy[1:-1, :-1, 1:-1]) * inv_di[1]
        + (Vz[1:-1, 1:-1, 1:] - Vz[1:-1, 1:-1, :-1]) * inv_di[2]
    )


def compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di, inv_di_v=None):
    """Deviatoric strain rate: normal at centers, shear on edges
    (VelocityKernels.jl:59-104).

    ``inv_di`` is the center spacing family (cell widths — normal strains
    land at centers); ``inv_di_v`` the vertex family (center-to-center
    distances, clamped at boundary faces — the shear derivatives land on
    edges and run BETWEEN cell positions). On a uniform grid they coincide
    (the default). Reference nonuniform `_di` variants: Grid.jl:262-316."""
    _dx, _dy, _dz = inv_di
    _dxv, _dyv, _dzv = inv_di if inv_di_v is None else inv_di_v
    third = 1.0 / 3.0
    exx = (Vx[1:, 1:-1, 1:-1] - Vx[:-1, 1:-1, 1:-1]) * _dx - grad_V * third
    eyy = (Vy[1:-1, 1:, 1:-1] - Vy[1:-1, :-1, 1:-1]) * _dy - grad_V * third
    ezz = (Vz[1:-1, 1:-1, 1:] - Vz[1:-1, 1:-1, :-1]) * _dz - grad_V * third
    eyz = 0.5 * (
        (Vy[1:-1, :, 1:] - Vy[1:-1, :, :-1]) * _dzv
        + (Vz[1:-1, 1:, :] - Vz[1:-1, :-1, :]) * _dyv
    )
    exz = 0.5 * (
        (Vx[:, 1:-1, 1:] - Vx[:, 1:-1, :-1]) * _dzv
        + (Vz[1:, 1:-1, :] - Vz[:-1, 1:-1, :]) * _dxv
    )
    exy = 0.5 * (
        (Vx[:, 1:, 1:-1] - Vx[:, :-1, 1:-1]) * _dyv
        + (Vy[1:, :, 1:-1] - Vy[:-1, :, 1:-1]) * _dxv
    )
    return exx, eyy, ezz, eyz, exz, exy


def _av_edge_xy(A):
    """Centers → interior xy-edges (nx-1, ny-1, nz)."""
    return 0.25 * (A[:-1, :-1, :] + A[1:, :-1, :] + A[:-1, 1:, :] + A[1:, 1:, :])


def _av_edge_xz(A):
    return 0.25 * (A[:-1, :, :-1] + A[1:, :, :-1] + A[:-1, :, 1:] + A[1:, :, 1:])


def _av_edge_yz(A):
    return 0.25 * (A[:, :-1, :-1] + A[:, 1:, :-1] + A[:, :-1, 1:] + A[:, 1:, 1:])


def _dtau_r(theta_dtau, eta, _Gdt):
    return 1.0 / (theta_dtau + eta * _Gdt + 1.0)


def _inc(tau, tau_o, eta, eps, _Gdt, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


def _pad_edge2(A, ax0, ax1):
    pads = [(0, 0)] * 3
    pads[ax0] = (1, 1)
    pads[ax1] = (1, 1)
    return jnp.pad(A, pads, mode="edge")


def _pad2(A, ax0, ax1):
    """Zero-pad one layer on both sides of two axes (pad+add idiom: a
    zero-pad fuses into the add, see ops/stencil.py::interior_add)."""
    pads = [(0, 0)] * 3
    pads[ax0] = (1, 1)
    pads[ax1] = (1, 1)
    return jnp.pad(A, pads)


def compute_tau_ve_3d(tau, tau_o, eps, eta, G, theta_dtau, dt, boundary_shear=False):
    """VE PT stress update (StressKernels.jl:148-232). ``tau``/``tau_o``/``eps``
    are 6-tuples (xx, yy, zz, yz, xz, xy).

    ``boundary_shear=False`` mirrors the reference: shear components update
    only on interior edges (boundary edges stay at their BC-determined value —
    correct for free-slip where τ_shear = 0). With ``True``, boundary edges
    update too (clamped-average material properties) — required for
    Dirichlet-velocity problems (e.g. Burstedde) where the physical boundary
    shear stress is nonzero; the reference leaves those edges at 0, which is
    inconsistent (its Burstedde test is excluded from CI, runtests.jl:60-62).
    """
    txx, tyy, tzz, tyz, txz, txy = tau
    txx_o, tyy_o, tzz_o, tyz_o, txz_o, txy_o = tau_o
    exx, eyy, ezz, eyz, exz, exy = eps

    _Gdt = 1.0 / (G * dt)
    dr = _dtau_r(theta_dtau, eta, _Gdt)
    txx = txx + _inc(txx, txx_o, eta, exx, _Gdt, dr)
    tyy = tyy + _inc(tyy, tyy_o, eta, eyy, _Gdt, dr)
    tzz = tzz + _inc(tzz, tzz_o, eta, ezz, _Gdt, dr)

    if boundary_shear:
        # clamped-average η/G onto ALL edges, update every edge value
        def upd(t, t_o, e, av, ax0, ax1):
            eta_e = av(_pad_edge2(eta, ax0, ax1))
            G_e = av(_pad_edge2(G, ax0, ax1))
            _G_e = 1.0 / (G_e * dt)
            dr_e = _dtau_r(theta_dtau, eta_e, _G_e)
            return t + _inc(t, t_o, eta_e, e, _G_e, dr_e)

        txy = upd(txy, txy_o, exy, _av_edge_xy, 0, 1)
        txz = upd(txz, txz_o, exz, _av_edge_xz, 0, 2)
        tyz = upd(tyz, tyz_o, eyz, _av_edge_yz, 1, 2)
        return txx, tyy, tzz, tyz, txz, txy

    eta_xy, G_xy = _av_edge_xy(eta), _av_edge_xy(G)
    _G_xy = 1.0 / (G_xy * dt)
    dr_xy = _dtau_r(theta_dtau, eta_xy, _G_xy)
    txy = txy + _pad2(
        _inc(txy[1:-1, 1:-1, :], txy_o[1:-1, 1:-1, :], eta_xy, exy[1:-1, 1:-1, :], _G_xy, dr_xy),
        0, 1,
    )
    eta_xz, G_xz = _av_edge_xz(eta), _av_edge_xz(G)
    _G_xz = 1.0 / (G_xz * dt)
    dr_xz = _dtau_r(theta_dtau, eta_xz, _G_xz)
    txz = txz + _pad2(
        _inc(txz[1:-1, :, 1:-1], txz_o[1:-1, :, 1:-1], eta_xz, exz[1:-1, :, 1:-1], _G_xz, dr_xz),
        0, 2,
    )
    eta_yz, G_yz = _av_edge_yz(eta), _av_edge_yz(G)
    _G_yz = 1.0 / (G_yz * dt)
    dr_yz = _dtau_r(theta_dtau, eta_yz, _G_yz)
    tyz = tyz + _pad2(
        _inc(tyz[:, 1:-1, 1:-1], tyz_o[:, 1:-1, 1:-1], eta_yz, eyz[:, 1:-1, 1:-1], _G_yz, dr_yz),
        1, 2,
    )
    return txx, tyy, tzz, tyz, txz, txy


def compute_V_3d(Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, etadtau, inv_di,
                 spacings=None):
    """Fused residual + damped velocity update (VelocityKernels.jl:182-242).

    ``spacings`` is the optional nonuniform bundle ``(inv_dv_in, inv_dc)``:
    per-axis vertex-family reciprocals restricted to INTERIOR faces of the
    momentum component's own axis (normal-stress/pressure gradients span
    adjacent centers) and center-family reciprocals (shear-stress gradients
    span adjacent edges, one cell width apart). Defaults to the uniform
    ``inv_di`` for all.

    Returns (Vx, Vy, Vz, Rx, Ry, Rz)."""
    if spacings is None:
        _dx = _dy = _dz = None
        _dxv = _dyv = _dzv = None
    else:
        (_dxv, _dyv, _dzv), (_dx, _dy, _dz) = spacings
    u = inv_di
    _dx = u[0] if _dx is None else _dx
    _dy = u[1] if _dy is None else _dy
    _dz = u[2] if _dz is None else _dz
    _dxv = u[0] if _dxv is None else _dxv
    _dyv = u[1] if _dyv is None else _dyv
    _dzv = u[2] if _dzv is None else _dzv
    txx, tyy, tzz, tyz, txz, txy = tau

    Rx = (
        (txx[1:, :, :] - txx[:-1, :, :]) * _dxv
        + (txy[1:-1, 1:, :] - txy[1:-1, :-1, :]) * _dy
        + (txz[1:-1, :, 1:] - txz[1:-1, :, :-1]) * _dz
        - (P[1:, :, :] - P[:-1, :, :]) * _dxv
        - 0.5 * (fx[1:, :, :] + fx[:-1, :, :])
    )
    Ry = (
        (txy[1:, 1:-1, :] - txy[:-1, 1:-1, :]) * _dx
        + (tyy[:, 1:, :] - tyy[:, :-1, :]) * _dyv
        + (tyz[:, 1:-1, 1:] - tyz[:, 1:-1, :-1]) * _dz
        - (P[:, 1:, :] - P[:, :-1, :]) * _dyv
        - 0.5 * (fy[:, 1:, :] + fy[:, :-1, :])
    )
    Rz = (
        (txz[1:, :, 1:-1] - txz[:-1, :, 1:-1]) * _dx
        + (tyz[:, 1:, 1:-1] - tyz[:, :-1, 1:-1]) * _dy
        + (tzz[:, :, 1:] - tzz[:, :, :-1]) * _dzv
        - (P[:, :, 1:] - P[:, :, :-1]) * _dzv
        - 0.5 * (fz[:, :, 1:] + fz[:, :, :-1])
    )
    etax = 0.5 * (eta_tau[1:, :, :] + eta_tau[:-1, :, :])
    etay = 0.5 * (eta_tau[:, 1:, :] + eta_tau[:, :-1, :])
    etaz = 0.5 * (eta_tau[:, :, 1:] + eta_tau[:, :, :-1])
    # pad+add instead of .at[interior].add — see _pad2
    p1 = ((1, 1), (1, 1), (1, 1))
    Vx = Vx + jnp.pad(Rx * etadtau / etax, p1)
    Vy = Vy + jnp.pad(Ry * etadtau / etay, p1)
    Vz = Vz + jnp.pad(Rz * etadtau / etaz, p1)
    return Vx, Vy, Vz, Rx, Ry, Rz


def tensor_invariant_staggered_3d(xx, yy, zz, yz, xz, xy):
    """Second invariant at centers: normal pointwise, shear from the mean of
    squared gathered edge values (StressKernels.jl:479-492)."""
    yz2 = 0.25 * (yz[:, :-1, :-1] ** 2 + yz[:, 1:, :-1] ** 2 + yz[:, :-1, 1:] ** 2 + yz[:, 1:, 1:] ** 2)
    xz2 = 0.25 * (xz[:-1, :, :-1] ** 2 + xz[1:, :, :-1] ** 2 + xz[:-1, :, 1:] ** 2 + xz[1:, :, 1:] ** 2)
    xy2 = 0.25 * (xy[:-1, :-1, :] ** 2 + xy[1:, :-1, :] ** 2 + xy[:-1, 1:, :] ** 2 + xy[1:, 1:, :] ** 2)
    return jnp.sqrt(0.5 * (xx**2 + yy**2 + zz**2) + yz2 + xz2 + xy2)
