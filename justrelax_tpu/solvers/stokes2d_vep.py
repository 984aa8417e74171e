"""Multi-phase visco-elasto-plastic APT Stokes solver, 2D (the flagship).

Re-design of the reference driver ``_solve!`` with phase ratios
(/root/reference/src/stokes/Stokes2D.jl:577-883): per PT iteration —
maxloc preconditioner → divergence → compressible pressure iterate θ →
buoyancy refresh → strain rate → fused center+vertex VEP stress update
(with plastic return mapping and dilatancy pressure correction
P = θ − K·dt·λ·∂Q/∂P) → τII-based viscosity relaxation → damped velocity
update + BCs. Convergence checked every ``nout`` on device.

State evolution per solve: P0 ← P at entry; τ_o ← τ, EII/EVol accumulation,
vorticity and shear-center interpolation at exit.
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
from justrelax_tpu.ops import stokes as kernels
from justrelax_tpu.ops.bc import VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stencil import av_a, av_vertex_to_center, maxloc
from justrelax_tpu.ops.stokes_vep import update_stresses_center_vertex
from justrelax_tpu.rheology.materials import (
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
)
from justrelax_tpu.rheology.plasticity import second_invariant_staggered
from justrelax_tpu.rheology.viscosity import compute_viscosity_fields
from justrelax_tpu.solvers.stokes2d import StokesSolveInfo, _norm

Array = Any

__all__ = ["solve_vep"]

def _gather4(A):
    """4 vertex values around each center: (A[i,j], A[i+1,j], A[i,j+1], A[i+1,j+1])."""
    return (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])


@partial(
    jax.jit,
    static_argnames=(
        "geometry",
        "flow_bc",
        "iter_max",
        "iter_min",
        "nout",
        "free_surface",
        "viscosity_relaxation",
        "lambda_relaxation",
        "viscosity_cutoff",
        "visc_plastic_tau",
    ),
)
def solve_vep(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    material,
    phase_ratios_center: Optional[Array],
    phase_ratios_vertex: Optional[Array],
    dt,
    T: Optional[Array] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    free_surface: bool = False,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-jnp.inf, jnp.inf),
    visc_plastic_tau: bool = False,
) -> Tuple[StokesState, StokesSolveInfo]:
    """One VEP Stokes solve (one physical timestep) with phase ratios.

    ``T`` (cell centers) enters the temperature-dependent density and
    creep laws and is frozen during the solve. Each ``nout`` chunk runs
    ``nout - 1`` reduced-carry iterations plus one full iteration that
    produces every diagnostic (tau_II, eta_vep, eps_pl, RP)."""
    nx, ny = stokes.P.shape
    if hasattr(geometry, "di_center"):  # nonuniform vector-spacing grid
        # same kernel families as the VE solver (reference
        # VelocityKernels.jl _di_center/_di_vertex variants)
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
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    fs_dt = dt if free_surface else None
    dtype = stokes.P.dtype

    P0 = stokes.P  # P0 ← P at solve entry (reference :610)
    Q = stokes.Q
    txx_o, tyy_o = stokes.tau_o.xx, stokes.tau_o.yy
    txy_c_o, txy_v_o = stokes.tau_o.xy_c, stokes.tau_o.xy
    EII_pl = stokes.EII_pl

    K_c = get_bulk_modulus(material, phase_ratios_center)
    G_c = get_shear_modulus(material, phase_ratios_center)
    T_vertex = None if T is None else av_vertex_to_center(jnp.pad(T, 1, mode="edge"))

    # buoyancy: ρ(T, P)·g along −y (pointing down = +g sign as in ρg arrays)
    def rho_g_fields(P):
        rho = compute_density(material, T=T, P=P, phase_ratios=phase_ratios_center)
        from justrelax_tpu.rheology.materials import _as_stack, phase_average

        g = phase_average(_as_stack(material).params.gravity, phase_ratios_center)
        g = jnp.broadcast_to(g, rho.shape)
        return jnp.zeros_like(rho), rho * g

    class C(NamedTuple):
        Vx: Array
        Vy: Array
        P: Array  # corrected pressure (stokes.P)
        theta: Array  # pressure iterate
        txx: Array
        tyy: Array
        txy_c: Array
        txy_v: Array
        eta: Array
        eta_v: Array
        lam: Array
        lam_v: Array
        tau_II: Array
        eta_vep: Array
        eps_pl: Tuple  # (xx, yy, xy_v)
        eps_vol_pl: Array
        RP: Array
        err: Array
        err1: Array
        chunk: Array
        hist: Array

    def one_iteration(_, c: C):
        eta_tau = maxloc(c.eta, window=1)
        grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
        RP, theta = kernels.compute_P(
            c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau
        )
        rho_gx, rho_gy = rho_g_fields(c.P)
        exx, eyy, exy = kernels.compute_strain_rate(
            grad_V, c.Vx, c.Vy, inv_dx, inv_dy, **strain_v
        )
        res = update_stresses_center_vertex(
            exx, eyy, exy,
            c.txx, c.tyy, c.txy_c, c.txy_v,
            txx_o, tyy_o, txy_c_o, txy_v_o,
            theta, c.eta, c.lam, c.lam_v, EII_pl,
            material, phase_ratios_center, phase_ratios_vertex,
            lambda_relaxation, dt, theta_dtau,
        )
        vp_kw = {}
        if visc_plastic_tau:
            # PARITY.md hypothesis #2 variant: the regularized plastic
            # element enters the τII-mode composite; yield needs P
            from justrelax_tpu.ops.interpolation import center2vertex
            vp_kw = dict(plastic_in_tau=True, P=res.P_corrected,
                         P_v=center2vertex(res.P_corrected))
        eta, eta_v = compute_viscosity_fields(
            c.eta, c.eta_v, material,
            res.txx, res.tyy, res.txy_c,
            jnp.zeros_like(c.eta_v), jnp.zeros_like(c.eta_v), res.txy_v,
            phase_ratios_center, phase_ratios_vertex,
            T=T, T_v=T_vertex,
            mode="tau",
            relaxation=viscosity_relaxation,
            cutoff=viscosity_cutoff,
            **vp_kw,
        )
        Vx, Vy = kernels.compute_V(
            c.Vx, c.Vy, res.P_corrected, res.txx, res.tyy, res.txy_v,
            etadtau, rho_gx, rho_gy, eta_tau, inv_dx, inv_dy,
            free_surface_dt=fs_dt, spacings=mom_spacings,
        )
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
        return c._replace(
            Vx=Vx, Vy=Vy, P=res.P_corrected, theta=theta,
            txx=res.txx, tyy=res.tyy, txy_c=res.txy_c, txy_v=res.txy_v,
            eta=eta, eta_v=eta_v, lam=res.lam, lam_v=res.lam_v,
            tau_II=res.tau_II, eta_vep=res.eta_vep,
            eps_pl=(res.eps_pl_xx, res.eps_pl_yy, res.eps_pl_xy_v),
            eps_vol_pl=res.eps_vol_pl, RP=RP,
        )

    def residual_norms(c: C):
        rho_gx, rho_gy = rho_g_fields(c.P)
        Rx, Ry = kernels.compute_Res(
            c.P, c.txx, c.tyy, c.txy_v, rho_gx, rho_gy, inv_dx, inv_dy,
            Vy=c.Vy, free_surface_dt=fs_dt, spacings=mom_spacings,
        )
        nRx = _norm(Rx[1:-1, 1:-1]) / math.sqrt((nx - 2) * (ny - 1))
        nRy = _norm(Ry[1:-1, 1:-1]) / math.sqrt((nx - 1) * (ny - 2))
        nRP = _norm(c.RP) / math.sqrt(nx * ny)
        return nRx, nRy, nRP, Rx, Ry

    def cond(c: C):
        not_conv = ((c.err / c.err1) > eps_rel) & (c.err > eps_abs)
        return (c.chunk < min_chunks) | (not_conv & (c.chunk < max_chunks))

    _CORE = ("Vx", "Vy", "P", "theta", "txx", "tyy", "txy_c", "txy_v",
             "eta", "eta_v", "lam", "lam_v")

    def one_iteration_core(i, t):
        # reduced carry: the diagnostic fields (tau_II, eta_vep, eps_pl,
        # eps_vol_pl, RP) are pure outputs never read by the next iteration;
        # keeping them out of the fori carry drops their share of the
        # per-iteration memory traffic and lets XLA dead-code-eliminate
        # their computation inside the loop.
        c = _core_template._replace(**dict(zip(_CORE, t)))
        c2 = one_iteration(i, c)
        return tuple(getattr(c2, k) for k in _CORE)

    def body(c: C):
        t = lax.fori_loop(
            0, nout_i - 1, one_iteration_core,
            tuple(getattr(c, k) for k in _CORE),
        )
        # chunk-final full iteration produces every diagnostic exactly
        c = one_iteration(0, c._replace(**dict(zip(_CORE, t))))
        nRx, nRy, nRP, _, _ = residual_norms(c)
        err = jnp.maximum(jnp.maximum(nRx, nRy), nRP)
        err1 = jnp.where(c.chunk == 0, err, c.err1)
        hist = lax.dynamic_update_index_in_dim(
            c.hist, jnp.stack([nRx, nRy, nRP]), c.chunk, 0
        )
        return c._replace(err=err, err1=err1, chunk=c.chunk + 1, hist=hist)

    init = C(
        Vx=stokes.V.Vx,
        Vy=stokes.V.Vy,
        P=stokes.P,
        theta=stokes.P,
        txx=stokes.tau.xx,
        tyy=stokes.tau.yy,
        txy_c=stokes.tau.xy_c,
        txy_v=stokes.tau.xy,
        eta=stokes.viscosity.eta,
        eta_v=stokes.viscosity.eta_v,
        lam=jnp.zeros_like(stokes.P),
        lam_v=jnp.zeros_like(stokes.tau.xy),
        tau_II=stokes.tau.II,
        eta_vep=stokes.viscosity.eta_vep,
        eps_pl=(
            jnp.zeros_like(stokes.P),
            jnp.zeros_like(stokes.P),
            jnp.zeros_like(stokes.tau.xy),
        ),
        eps_vol_pl=jnp.zeros_like(stokes.P),
        RP=stokes.R.RP,
        err=jnp.asarray(jnp.inf, dtype),
        err1=jnp.asarray(1.0, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        hist=jnp.full((max_chunks, 3), jnp.nan, dtype),
    )
    _core_template = init
    c = lax.while_loop(cond, body, init)

    # --- post-loop diagnostics & state assembly ----------------------------
    grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
    exx, eyy, exy = kernels.compute_strain_rate(
        grad_V, c.Vx, c.Vy, inv_dx, inv_dy, **strain_v
    )
    nRx, nRy, nRP, Rx, Ry = residual_norms(c)
    omega_xy = kernels.compute_vorticity(
        c.Vx, c.Vy,
        strain_v.get("inv_dx_v", inv_dx), strain_v.get("inv_dy_v", inv_dy),
    )

    eps_pl_xx, eps_pl_yy, eps_pl_xy_v = c.eps_pl
    # shear2center + plastic strain accumulation (reference :847-856)
    exy_c = av_a(exy)
    eps_pl_xy_c = av_a(eps_pl_xy_v)
    EII_new = EII_pl + second_invariant_staggered(
        eps_pl_xx, eps_pl_yy, _gather4(eps_pl_xy_v)
    ) * dt
    EVol_new = stokes.EVol_pl + dt * c.eps_vol_pl

    tau = stokes.tau.replace(
        xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c, II=c.tau_II
    )
    tau_o = stokes.tau_o.replace(xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c)
    eps = stokes.eps.replace(
        xx=exx, yy=eyy, xy=exy, xy_c=exy_c,
        II=second_invariant_staggered(exx, eyy, _gather4(exy)),
    )
    eps_pl = stokes.eps_pl.replace(
        xx=eps_pl_xx, yy=eps_pl_yy, xy=eps_pl_xy_v, xy_c=eps_pl_xy_c
    )
    new_stokes = stokes.replace(
        P=c.P,
        P0=P0,
        V=stokes.V.replace(Vx=c.Vx, Vy=c.Vy),
        grad_V=grad_V,
        tau=tau,
        tau_o=tau_o,
        eps=eps,
        eps_pl=eps_pl,
        EII_pl=EII_new,
        EVol_pl=EVol_new,
        eps_vol_pl=c.eps_vol_pl,
        lam=c.lam,
        lam_v=c.lam_v,
        viscosity=stokes.viscosity.replace(
            eta=c.eta, eta_v=c.eta_v, eta_vep=c.eta_vep, eta_tau=maxloc(c.eta, 1)
        ),
        omega=stokes.omega.replace(xy=omega_xy),
        R=stokes.R.replace(RP=c.RP, Rx=Rx, Ry=Ry),
    )
    info = StokesSolveInfo(
        iters=c.chunk * nout_i,
        err=c.err,
        err_history=jnp.max(c.hist, axis=1),
        norm_Rx=c.hist[:, 0],
        norm_Ry=c.hist[:, 1],
        norm_RP=c.hist[:, 2],
    )
    return new_stokes, info
