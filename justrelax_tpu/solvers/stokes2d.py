"""Accelerated pseudo-transient Stokes solvers, 2D.

Re-design of the reference solve routines
(/root/reference/src/stokes/Stokes2D.jl). This module provides the linear
viscous / visco-elastic solver (reference ``_solve!`` variants at
Stokes2D.jl:19-163 and 181-341); the nonlinear VEP (GeoParams) and multi-phase
drivers live in stokes2d_vep.py.

Design: the PT loop is a device-resident ``lax.while_loop`` whose body runs
``nout`` fused iterations (divergence → pressure → strain rate → stress →
damped velocity + BCs) via ``lax.fori_loop``, then evaluates the residual
norms — matching the reference's every-``nout`` convergence check without
per-iteration host syncs.

Convergence (Stokes2D.jl:63, 233): run at least one chunk; stop when
``err/err₁ ≤ ϵ_rel`` or ``err ≤ ϵ_abs``; cap at ``iter_max``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.ops import stokes as kernels
from justrelax_tpu.ops.bc import VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stencil import av_vertex_to_center, maxloc

Array = Any

__all__ = ["solve_ve", "StokesSolveInfo"]


class StokesSolveInfo(NamedTuple):
    iters: Array
    err: Array
    err_history: Array  # (max_chunks,) max-norm history, nan-padded
    norm_Rx: Array
    norm_Ry: Array
    norm_RP: Array


class _Carry(NamedTuple):
    Vx: Array
    Vy: Array
    P: Array
    txx: Array
    tyy: Array
    txy: Array
    RP: Array
    err: Array
    err1: Array
    chunk: Array
    hist: Array  # (max_chunks, 3): norm_Rx, norm_Ry, norm_RP


def _norm(x):
    return jnp.linalg.norm(x.ravel())


@partial(
    jax.jit,
    static_argnames=(
        "geometry",
        "flow_bc",
        "iter_max",
        "nout",
        "free_surface",
        "halo_exchange",
        "reduce_norm",
    ),
)
def solve_ve(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    rho_g: Tuple[Array, Array],
    G: Array,
    K: Array,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
    free_surface: bool = False,
    halo_exchange=None,
    reduce_norm=None,
    alpha_dT=None,
) -> Tuple[StokesState, StokesSolveInfo]:
    """Visco-elastic (compressible) APT Stokes solve, one physical timestep.

    Mirrors reference Stokes2D.jl:181-341: pressure relaxed with the maxloc
    preconditioner ``ητ``, stress updated with the VE PT increment, velocity
    damped by ``ηdτ/ητ̄``. ``G``/``K`` may be ∞ for viscous/incompressible
    limits (SolCx et al.). ``alpha_dT = α·ΔT`` (cell-centered) adds the
    thermal-stress pressure source of Kiss et al. 2023 (reference
    PressureKernels.jl:197-206).
    """
    nx, ny = stokes.P.shape
    if hasattr(geometry, "di_center"):  # nonuniform vector-spacing grid
        dcx = jnp.asarray(geometry.di_center[0])[:, None]
        dcy = jnp.asarray(geometry.di_center[1])[None, :]
        dvx = jnp.asarray(geometry.di_vertex[0])[:, None]
        dvy = jnp.asarray(geometry.di_vertex[1])[None, :]
        inv_dx, inv_dy = 1.0 / dcx, 1.0 / dcy  # center family (cell widths)
        strain_v = dict(inv_dx_v=1.0 / dvx, inv_dy_v=1.0 / dvy)
        mom_spacings = (
            1.0 / dvx[1:-1], 1.0 / dcy,  # x momentum: vertex-x, center-y
            1.0 / dvy[:, 1:-1], 1.0 / dcx,  # y momentum: vertex-y, center-x
        )
    else:
        inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
        strain_v = {}
        mom_spacings = None
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout)))
    fs_dt = dt if free_surface else None

    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    if halo_exchange is not None:
        eta_tau = halo_exchange(eta_tau)

    P0, Q = stokes.P0, stokes.Q
    txx_o, tyy_o, txy_o = stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy
    rho_gx, rho_gy = rho_g

    def one_iteration(_, c):
        Vx, Vy, P, txx, tyy, txy = c
        grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
        RP, P = kernels.compute_P(
            P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau, alpha_dT=alpha_dT
        )
        exx, eyy, exy = kernels.compute_strain_rate(
            grad_V, Vx, Vy, inv_dx, inv_dy, **strain_v
        )
        txx, tyy, txy = kernels.compute_tau_ve(
            txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy, eta, G, theta_dtau, dt
        )
        Vx, Vy = kernels.compute_V(
            Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy, eta_tau,
            inv_dx, inv_dy, free_surface_dt=fs_dt, spacings=mom_spacings,
        )
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
        if halo_exchange is not None:
            Vx, Vy = halo_exchange(Vx), halo_exchange(Vy)
        return (Vx, Vy, P, txx, tyy, txy)

    def residual_norms(Vx, Vy, P, txx, tyy, txy):
        grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
        RP, _ = kernels.compute_P(
            P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau, alpha_dT=alpha_dT
        )
        Rx, Ry = kernels.compute_Res(
            P, txx, tyy, txy, rho_gx, rho_gy, inv_dx, inv_dy,
            Vy=Vy, free_surface_dt=fs_dt, spacings=mom_spacings,
        )
        if reduce_norm is not None:
            nRx = reduce_norm(Rx[1:-1, 1:-1], ((nx - 2), (ny - 1)))
            nRy = reduce_norm(Ry[1:-1, 1:-1], ((nx - 1), (ny - 2)))
            nRP = reduce_norm(RP, (nx, ny))
        else:
            nRx = _norm(Rx[1:-1, 1:-1]) / math.sqrt((nx - 2) * (ny - 1))
            nRy = _norm(Ry[1:-1, 1:-1]) / math.sqrt((nx - 1) * (ny - 2))
            nRP = _norm(RP) / math.sqrt(nx * ny)
        return nRx, nRy, nRP, RP, Rx, Ry

    def cond(c: _Carry):
        not_converged = ((c.err / c.err1) > eps_rel) & (c.err > eps_abs)
        return (c.chunk < 1) | (not_converged & (c.chunk < max_chunks))

    def body(c: _Carry):
        Vx, Vy, P, txx, tyy, txy = lax.fori_loop(
            0, nout, one_iteration, (c.Vx, c.Vy, c.P, c.txx, c.tyy, c.txy)
        )
        nRx, nRy, nRP, RP, _, _ = residual_norms(Vx, Vy, P, txx, tyy, txy)
        err = jnp.maximum(jnp.maximum(nRx, nRy), nRP)
        err1 = jnp.where(c.chunk == 0, err, c.err1)
        hist = lax.dynamic_update_index_in_dim(
            c.hist, jnp.stack([nRx, nRy, nRP]), c.chunk, 0
        )
        return _Carry(Vx, Vy, P, txx, tyy, txy, RP, err, err1, c.chunk + 1, hist)

    dtype = stokes.P.dtype
    init = _Carry(
        Vx=stokes.V.Vx,
        Vy=stokes.V.Vy,
        P=stokes.P,
        txx=stokes.tau.xx,
        tyy=stokes.tau.yy,
        txy=stokes.tau.xy,
        RP=stokes.R.RP,
        err=jnp.asarray(jnp.inf, dtype),
        err1=jnp.asarray(1.0, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        hist=jnp.full((max_chunks, 3), jnp.nan, dtype),
    )
    c = lax.while_loop(cond, body, init)

    # final diagnostics + state assembly
    grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
    exx, eyy, exy = kernels.compute_strain_rate(
        grad_V, c.Vx, c.Vy, inv_dx, inv_dy, **strain_v
    )
    nRx, nRy, nRP, RP, Rx, Ry = residual_norms(c.Vx, c.Vy, c.P, c.txx, c.tyy, c.txy)
    txy_c = av_vertex_to_center(c.txy)
    exy_c = av_vertex_to_center(exy)
    tau = stokes.tau.replace(
        xx=c.txx,
        yy=c.tyy,
        xy=c.txy,
        xy_c=txy_c,
        II=kernels.tensor_invariant_2d(c.txx, c.tyy, txy_c),
    )
    tau_o = stokes.tau_o.replace(xx=c.txx, yy=c.tyy, xy=c.txy, xy_c=txy_c)
    eps = stokes.eps.replace(
        xx=exx, yy=eyy, xy=exy, xy_c=exy_c,
        II=kernels.tensor_invariant_2d(exx, eyy, exy_c),
    )
    omega = stokes.omega.replace(
        xy=kernels.compute_vorticity(
            c.Vx, c.Vy,
            strain_v.get("inv_dx_v", inv_dx), strain_v.get("inv_dy_v", inv_dy),
        )
    )
    new_stokes = stokes.replace(
        P=c.P,
        V=stokes.V.replace(Vx=c.Vx, Vy=c.Vy),
        grad_V=grad_V,
        tau=tau,
        tau_o=tau_o,
        eps=eps,
        omega=omega,
        viscosity=stokes.viscosity.replace(eta_tau=eta_tau),
        R=stokes.R.replace(RP=RP, Rx=Rx, Ry=Ry),
    )
    info = StokesSolveInfo(
        iters=c.chunk * nout,
        err=c.err,
        err_history=jnp.max(c.hist, axis=1),
        norm_Rx=c.hist[:, 0],
        norm_Ry=c.hist[:, 1],
        norm_RP=c.hist[:, 2],
    )
    return new_stokes, info
