"""Multi-phase visco-elasto-plastic APT Stokes solver, 3D.

3D twin of :mod:`justrelax_tpu.solvers.stokes2d_vep` (reference 3D driver
``_solve!`` with GeoParams, /root/reference/src/stokes/Stokes3D.jl:204-660):
per PT iteration — divergence → compressible pressure iterate θ → strain
rate → fused center+edge VEP stress update (plastic return mapping at
centers and all three shear-edge families, dilatancy pressure correction)
→ τII-based viscosity relaxation → damped velocity update + BCs.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.ops import stokes3d as k3
from justrelax_tpu.ops.bc import VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stencil import interior_set, maxloc
from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.ops.stokes3d_vep import (
    _edge_to_center,
    _inv_II,
    update_stresses_center_edges_3d,
)
from justrelax_tpu.rheology.materials import (
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
    _as_stack,
)
from justrelax_tpu.rheology.viscosity import (
    continuation_linear,
    phase_viscosity,
)
from justrelax_tpu.solvers.stokes2d import StokesSolveInfo, _norm

Array = Any

__all__ = ["solve_vep_3d"]


def _masked_momentum_3d(P, tau6, fx, fy, fz, inv_di, phi, vm,
                        spacings=None):
    """ϕ-weighted interior-face momentum residuals (masked MiniKernels),
    matching solvers/stokes3d_variational.py. ``spacings`` is the nonuniform
    bundle of :func:`k3.compute_V_3d` (interior vertex family for the
    normal-stress/pressure gradients, center family for the shear ones)."""
    if spacings is None:
        _dx, _dy, _dz = inv_di
        _dxv, _dyv, _dzv = inv_di
    else:
        (_dxv, _dyv, _dzv), (_dx, _dy, _dz) = spacings
    txx, tyy, tzz, tyz, txz, txy = tau6
    Pw = P * phi.center
    txxw, tyyw, tzzw = txx * phi.center, tyy * phi.center, tzz * phi.center
    tyzw, txzw, txyw = tyz * phi.yz, txz * phi.xz, txy * phi.xy
    fxw, fyw, fzw = fx * phi.center, fy * phi.center, fz * phi.center
    Rx = (
        (txxw[1:, :, :] - txxw[:-1, :, :]) * _dxv
        + (txyw[1:-1, 1:, :] - txyw[1:-1, :-1, :]) * _dy
        + (txzw[1:-1, :, 1:] - txzw[1:-1, :, :-1]) * _dz
        - (Pw[1:, :, :] - Pw[:-1, :, :]) * _dxv
        - 0.5 * (fxw[1:, :, :] + fxw[:-1, :, :])
    )
    Ry = (
        (txyw[1:, 1:-1, :] - txyw[:-1, 1:-1, :]) * _dx
        + (tyyw[:, 1:, :] - tyyw[:, :-1, :]) * _dyv
        + (tyzw[:, 1:-1, 1:] - tyzw[:, 1:-1, :-1]) * _dz
        - (Pw[:, 1:, :] - Pw[:, :-1, :]) * _dyv
        - 0.5 * (fyw[:, 1:, :] + fyw[:, :-1, :])
    )
    Rz = (
        (txzw[1:, :, 1:-1] - txzw[:-1, :, 1:-1]) * _dx
        + (tyzw[:, 1:, 1:-1] - tyzw[:, :-1, 1:-1]) * _dy
        + (tzzw[:, :, 1:] - tzzw[:, :, :-1]) * _dzv
        - (Pw[:, :, 1:] - Pw[:, :, :-1]) * _dzv
        - 0.5 * (fzw[:, :, 1:] + fzw[:, :, :-1])
    )
    Rx = jnp.where(vm.vx[1:-1, :, :], Rx, 0.0)
    Ry = jnp.where(vm.vy[:, 1:-1, :], Ry, 0.0)
    Rz = jnp.where(vm.vz[:, :, 1:-1], Rz, 0.0)
    return Rx, Ry, Rz


@partial(
    jax.jit,
    static_argnames=(
        "geometry", "flow_bc", "iter_max", "iter_min", "nout",
        "viscosity_relaxation", "lambda_relaxation", "viscosity_cutoff",
    ),
)
def solve_vep_3d(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    material,
    phase_ratios_center: Optional[Array],
    phase_ratios_edges,  # (yz, xz, xy) ratios or (None, None, None)
    dt,
    T: Optional[Array] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-jnp.inf, jnp.inf),
    phi=None,
) -> Tuple[StokesState, StokesSolveInfo]:
    """One multi-phase VEP Stokes solve (one physical timestep).

    With ``phi`` (a :class:`~justrelax_tpu.ops.rock_ratio.RockRatio3D`)
    the solve becomes the MASKED variational VEP (reference
    variational_stokes/Stokes3D.jl): air carries no equations, stencil
    differences are φ-weighted, invalid faces hard-zeroed — the 3D
    combination of solve_variational_3d's masking with the fused plastic
    return mapping."""
    nx, ny, nz = stokes.P.shape
    # nonuniform vector-spacing families (reference Grid.jl:262-316)
    inv_di, inv_di_v, mom_spacings = k3.spacing_families_3d(geometry)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    dtype = stokes.P.dtype

    P0 = stokes.P  # P0 ← P at solve entry
    Q = stokes.Q
    to = stokes.tau_o
    tau_o_c6 = (to.xx, to.yy, to.zz, to.yz_c, to.xz_c, to.xy_c)
    tau_o_e3 = (to.yz, to.xz, to.xy)
    EII_pl = stokes.EII_pl

    K_c = get_bulk_modulus(material, phase_ratios_center)
    G_c = get_shear_modulus(material, phase_ratios_center)

    # hoist solve-invariants of the fused stress update (phase blends + τ_o
    # edge interpolants; bitwise-equal to in-loop evaluation) out of the
    # loop: the three edge passes would otherwise recompute them per
    # iteration
    from justrelax_tpu.ops.stokes3d_vep import make_vep_params_3d

    vep_params = make_vep_params_3d(
        material, EII_pl, phase_ratios_center, phase_ratios_edges,
        tau_o_c6, tau_o_e3,
    )

    if phi is not None:
        from justrelax_tpu.ops.rock_ratio import valid_masks_3d

        vm = valid_masks_3d(phi)

        def mask_c(A):
            return jnp.where(vm.c, A, 0.0)

        def mask_tau(tau_c, tau_e):
            return (
                tuple(jnp.where(vm.c, x, 0.0) for x in tau_c),
                (
                    jnp.where(vm.yz, tau_e[0], 0.0),
                    jnp.where(vm.xz, tau_e[1], 0.0),
                    jnp.where(vm.xy, tau_e[2], 0.0),
                ),
            )
    else:
        vm = None

        def mask_c(A):
            return A

        def mask_tau(tau_c, tau_e):
            return tau_c, tau_e

    def rho_g_fields(P):
        rho = compute_density(material, T=T, P=P, phase_ratios=phase_ratios_center)
        g = phase_average(_as_stack(material).params.gravity, phase_ratios_center)
        z = jnp.zeros_like(rho)
        return z, z, rho * jnp.broadcast_to(g, rho.shape)

    def refresh_viscosity(eta_old, tau_c6):
        eps0 = jnp.where(
            sum(jnp.abs(t) for t in tau_c6) == 0, jnp.finfo(dtype).eps, 0.0
        )
        tII = _inv_II((tau_c6[0] + eps0,) + tau_c6[1:])
        eta_n = phase_viscosity(material, tII, T, phase_ratios_center, "tau")
        eta_n = continuation_linear(eta_n, eta_old, viscosity_relaxation)
        return jnp.clip(eta_n, viscosity_cutoff[0], viscosity_cutoff[1])

    class C(NamedTuple):
        V: Tuple
        P: Array
        theta: Array
        tau_c: Tuple
        tau_e: Tuple
        eta: Array
        lam: Array
        lam_e: Tuple
        tau_II: Array
        eta_vep: Array
        eps_pl_c: Tuple
        eps_pl_e: Tuple
        eps_vol_pl: Array
        RP: Array
        err: Array
        err1: Array
        chunk: Array
        hist: Array

    def one_iteration(_, c: C):
        Vx, Vy, Vz = c.V
        eta_tau = maxloc(c.eta, window=1)
        grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
        RP, theta = compute_P(
            c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau
        )
        fx, fy, fz = rho_g_fields(c.P)
        exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(
            grad_V, Vx, Vy, Vz, inv_di, inv_di_v
        )
        if vm is not None:
            exx, eyy, ezz = mask_c(exx), mask_c(eyy), mask_c(ezz)
            eyz = jnp.where(vm.yz, eyz, 0.0)
            exz = jnp.where(vm.xz, exz, 0.0)
            exy = jnp.where(vm.xy, exy, 0.0)
            theta = mask_c(theta)
            RP = mask_c(RP)
        res = update_stresses_center_edges_3d(
            (exx, eyy, ezz), (eyz, exz, exy),
            c.tau_c, c.tau_e, tau_o_c6, tau_o_e3,
            theta, c.eta, c.lam, c.lam_e, EII_pl,
            material, phase_ratios_center, phase_ratios_edges,
            lambda_relaxation, dt, theta_dtau,
            params=vep_params,
        )
        eta = refresh_viscosity(c.eta, res.tau_c)
        tau_c_m, tau_e_m = mask_tau(res.tau_c, res.tau_e)
        P_corr = mask_c(res.P_corrected)
        tau6 = tau_c_m[:3] + tau_e_m
        if vm is None:
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(
                Vx, Vy, Vz, P_corr, tau6, fx, fy, fz, eta_tau, etadtau,
                inv_di, spacings=mom_spacings,
            )
        else:
            Rx, Ry, Rz = _masked_momentum_3d(
                P_corr, tau6, fx, fy, fz, inv_di, phi, vm,
                spacings=mom_spacings,
            )
            etax = 0.5 * (eta_tau[1:, :, :] + eta_tau[:-1, :, :])
            etay = 0.5 * (eta_tau[:, 1:, :] + eta_tau[:, :-1, :])
            etaz = 0.5 * (eta_tau[:, :, 1:] + eta_tau[:, :, :-1])
            # fused masked add + invalid-face zeroing (mask+select idiom,
            # see ops/stencil.py::interior_set)
            Vx = interior_set(
                Vx,
                jnp.where(
                    vm.vx[1:-1, :, :],
                    Vx[1:-1, 1:-1, 1:-1] + Rx * etadtau / etax, 0.0,
                ),
            )
            Vy = interior_set(
                Vy,
                jnp.where(
                    vm.vy[:, 1:-1, :],
                    Vy[1:-1, 1:-1, 1:-1] + Ry * etadtau / etay, 0.0,
                ),
            )
            Vz = interior_set(
                Vz,
                jnp.where(
                    vm.vz[:, :, 1:-1],
                    Vz[1:-1, 1:-1, 1:-1] + Rz * etadtau / etaz, 0.0,
                ),
            )
        Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), flow_bc)
        return c._replace(
            V=(Vx, Vy, Vz), P=P_corr, theta=theta,
            tau_c=tau_c_m, tau_e=tau_e_m, eta=eta,
            lam=res.lam, lam_e=res.lam_e,
            tau_II=res.tau_II, eta_vep=res.eta_vep,
            eps_pl_c=res.eps_pl_c, eps_pl_e=res.eps_pl_e,
            eps_vol_pl=res.eps_vol_pl, RP=RP,
        )

    def residual_norms(c: C):
        fx, fy, fz = rho_g_fields(c.P)
        tau6 = (
            c.tau_c[0], c.tau_c[1], c.tau_c[2],
            c.tau_e[0], c.tau_e[1], c.tau_e[2],
        )
        if vm is None:
            _, _, _, Rx, Ry, Rz = k3.compute_V_3d(
                c.V[0] * 0.0, c.V[1] * 0.0, c.V[2] * 0.0, c.P, tau6,
                fx, fy, fz, jnp.ones_like(c.P), 0.0, inv_di,
                spacings=mom_spacings,
            )
        else:
            Rx, Ry, Rz = _masked_momentum_3d(
                c.P, tau6, fx, fy, fz, inv_di, phi, vm,
                spacings=mom_spacings,
            )
        nRx = _norm(Rx[1:-1, 1:-1, 1:-1]) / ((nx - 2) * (ny - 1) * (nz - 1))
        nRy = _norm(Ry[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 2) * (nz - 1))
        nRz = _norm(Rz[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 1) * (nz - 2))
        nRP = _norm(c.RP) / (nx * ny * nz)
        return nRx, nRy, nRz, nRP, Rx, Ry, Rz

    def cond(c: C):
        not_conv = ((c.err / c.err1) > eps_rel) & (c.err > eps_abs)
        return (c.chunk < min_chunks) | (not_conv & (c.chunk < max_chunks))

    _CORE = ("V", "P", "theta", "tau_c", "tau_e", "eta", "lam", "lam_e")

    def one_iteration_core(i, t):
        # reduced fori carry — diagnostics are write-only per iteration
        # (see solvers/stokes2d_vep.py)
        c = _core_template._replace(**dict(zip(_CORE, t)))
        c2 = one_iteration(i, c)
        return tuple(getattr(c2, k) for k in _CORE)

    def body(c: C):
        t = lax.fori_loop(
            0, nout_i - 1, one_iteration_core,
            tuple(getattr(c, k) for k in _CORE),
        )
        c = one_iteration(0, c._replace(**dict(zip(_CORE, t))))
        nRx, nRy, nRz, nRP, _, _, _ = residual_norms(c)
        err = jnp.max(jnp.stack([nRx, nRy, nRz, nRP]))
        err1 = jnp.where(c.chunk == 0, err, c.err1)
        hist = lax.dynamic_update_index_in_dim(
            c.hist, jnp.stack([nRx, nRy, nRz, nRP]), c.chunk, 0
        )
        return c._replace(err=err, err1=err1, chunk=c.chunk + 1, hist=hist)

    tau = stokes.tau
    init = C(
        V=(stokes.V.Vx, stokes.V.Vy, stokes.V.Vz),
        P=stokes.P, theta=stokes.P,
        tau_c=(tau.xx, tau.yy, tau.zz, tau.yz_c, tau.xz_c, tau.xy_c),
        tau_e=(tau.yz, tau.xz, tau.xy),
        eta=stokes.viscosity.eta,
        lam=jnp.zeros_like(stokes.P),
        lam_e=tuple(jnp.zeros_like(t) for t in (tau.yz, tau.xz, tau.xy)),
        tau_II=tau.II,
        eta_vep=stokes.viscosity.eta_vep,
        eps_pl_c=tuple(jnp.zeros_like(stokes.P) for _ in range(6)),
        eps_pl_e=tuple(jnp.zeros_like(t) for t in (tau.yz, tau.xz, tau.xy)),
        eps_vol_pl=jnp.zeros_like(stokes.P),
        RP=stokes.R.RP,
        err=jnp.asarray(jnp.inf, dtype),
        err1=jnp.asarray(1.0, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        hist=jnp.full((max_chunks, 4), jnp.nan, dtype),
    )
    _core_template = init
    c = lax.while_loop(cond, body, init)

    # --- post-loop diagnostics & state assembly ----------------------------
    Vx, Vy, Vz = c.V
    grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
    exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(
        grad_V, Vx, Vy, Vz, inv_di, inv_di_v
    )
    nRx, nRy, nRz, nRP, Rx, Ry, Rz = residual_norms(c)

    eyz_c = _edge_to_center(eyz, 1, 2)
    exz_c = _edge_to_center(exz, 0, 2)
    exy_c = _edge_to_center(exy, 0, 1)
    pl_yz_c = _edge_to_center(c.eps_pl_e[0], 1, 2)
    pl_xz_c = _edge_to_center(c.eps_pl_e[1], 0, 2)
    pl_xy_c = _edge_to_center(c.eps_pl_e[2], 0, 1)
    EII_new = EII_pl + _inv_II(
        (c.eps_pl_c[0], c.eps_pl_c[1], c.eps_pl_c[2], pl_yz_c, pl_xz_c, pl_xy_c)
    ) * dt
    EVol_new = stokes.EVol_pl + dt * c.eps_vol_pl

    txx, tyy, tzz, tyz_c, txz_c, txy_c = c.tau_c
    tyz, txz, txy = c.tau_e
    new_tau = tau.replace(
        xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy,
        yz_c=tyz_c, xz_c=txz_c, xy_c=txy_c, II=c.tau_II,
    )
    new_tau_o = stokes.tau_o.replace(
        xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy,
        yz_c=tyz_c, xz_c=txz_c, xy_c=txy_c,
    )
    new_eps = stokes.eps.replace(
        xx=exx, yy=eyy, zz=ezz, yz=eyz, xz=exz, xy=exy,
        yz_c=eyz_c, xz_c=exz_c, xy_c=exy_c,
        II=_inv_II((exx, eyy, ezz, eyz_c, exz_c, exy_c)),
    )
    new_eps_pl = stokes.eps_pl.replace(
        xx=c.eps_pl_c[0], yy=c.eps_pl_c[1], zz=c.eps_pl_c[2],
        yz=c.eps_pl_e[0], xz=c.eps_pl_e[1], xy=c.eps_pl_e[2],
        yz_c=pl_yz_c, xz_c=pl_xz_c, xy_c=pl_xy_c,
    )
    new_stokes = stokes.replace(
        P=c.P, P0=P0,
        V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz),
        tau=new_tau, tau_o=new_tau_o, eps=new_eps, eps_pl=new_eps_pl,
        EII_pl=EII_new, EVol_pl=EVol_new, eps_vol_pl=c.eps_vol_pl,
        lam=c.lam,
        viscosity=stokes.viscosity.replace(
            eta=c.eta, eta_vep=c.eta_vep, eta_tau=maxloc(c.eta, 1)
        ),
        R=stokes.R.replace(RP=c.RP, Rx=Rx, Ry=Ry, Rz=Rz),
    )
    info = StokesSolveInfo(
        iters=c.chunk * nout_i,
        err=c.err,
        err_history=jnp.max(c.hist, axis=1),
        norm_Rx=c.hist[:, 0],
        norm_Ry=c.hist[:, 1],
        norm_RP=c.hist[:, 3],
    )
    return new_stokes, info
