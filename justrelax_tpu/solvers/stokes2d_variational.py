"""Variational (embedded free-surface) APT Stokes solver, 2D.

Re-design of the reference ``solve_VariationalStokes!``
(/root/reference/src/variational_stokes/Stokes2D.jl:24-333): the standard
multi-phase VEP iteration with every kernel masked by the
:class:`~justrelax_tpu.ops.rock_ratio.RockRatio` — air cells carry no
equations (fields zeroed, updates skipped), stencil differences weight their
operands by the local rock fraction (masked MiniKernels), and residual norms
only count rock nodes.
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
from justrelax_tpu.ops.rock_ratio import RockRatio, valid_masks
from justrelax_tpu.ops.stencil import av_a, interior_add, interior_set, maxloc
from justrelax_tpu.ops.stokes_vep import update_stresses_center_vertex
from justrelax_tpu.rheology.materials import (
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
    _as_stack,
)
from justrelax_tpu.rheology.viscosity import compute_viscosity_fields
from justrelax_tpu.solvers.stokes2d import StokesSolveInfo, _norm

Array = Any

__all__ = ["solve_variational"]


@partial(
    jax.jit,
    static_argnames=(
        "geometry", "flow_bc", "iter_max", "iter_min", "nout",
        "viscosity_relaxation", "lambda_relaxation", "viscosity_cutoff",
        "air_phase", "mask_step_floor", "free_surface",
    ),
)
def solve_variational(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    material,
    phase_ratios_center: Array,
    phase_ratios_vertex: Array,
    phi: RockRatio,
    dt,
    T: Optional[Array] = None,
    iter_max: int = 50_000,
    iter_min: int = 100,
    nout: int = 500,
    viscosity_relaxation: float = 1.0e-2,
    lambda_relaxation: float = 0.2,
    viscosity_cutoff: Tuple[float, float] = (-jnp.inf, jnp.inf),
    air_phase: Optional[int] = None,
    mask_step_floor: float = 1.0,
    free_surface: bool = False,
) -> Tuple[StokesState, StokesSolveInfo]:
    nx, ny = stokes.P.shape
    if hasattr(geometry, "di_center"):  # nonuniform vector-spacing grid
        dcx = jnp.asarray(geometry.di_center[0])[:, None]
        dcy = jnp.asarray(geometry.di_center[1])[None, :]
        dvx = jnp.asarray(geometry.di_vertex[0])[:, None]
        dvy = jnp.asarray(geometry.di_vertex[1])[None, :]
        inv_dx, inv_dy = 1.0 / dcx, 1.0 / dcy  # center family (cell widths)
        strain_v = dict(inv_dx_v=1.0 / dvx, inv_dy_v=1.0 / dvy)
        # momentum families (reference VelocityKernels.jl:109-132):
        # x residual: vertex-x for ∂x, center-y for ∂y; y residual mirrored
        mom_x = (1.0 / dvx[1:-1], 1.0 / dcy)
        mom_y = (1.0 / dvy[:, 1:-1], 1.0 / dcx)
    else:
        inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
        strain_v = {}
        mom_x = (inv_dx, inv_dy)
        mom_y = (inv_dy, inv_dx)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    min_chunks = int(math.ceil(iter_min / nout_i))
    dtype = stokes.P.dtype

    vm = valid_masks(phi)
    P0, Q = stokes.P, stokes.Q
    txx_o, tyy_o = stokes.tau_o.xx, stokes.tau_o.yy
    txy_c_o, txy_v_o = stokes.tau_o.xy_c, stokes.tau_o.xy
    EII_pl = stokes.EII_pl
    K_c = get_bulk_modulus(material, phase_ratios_center)
    G_c = get_shear_modulus(material, phase_ratios_center)

    def rho_g_fields(P):
        rho = compute_density(material, T=T, P=P, phase_ratios=phase_ratios_center)
        g = phase_average(_as_stack(material).params.gravity, phase_ratios_center)
        return jnp.zeros_like(rho), rho * jnp.broadcast_to(g, rho.shape)

    def masked_strain(Vx, Vy):
        grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
        grad_V = jnp.where(vm.c, grad_V, 0.0)
        exx, eyy, exy = kernels.compute_strain_rate(
            grad_V, Vx, Vy, inv_dx, inv_dy, **strain_v
        )
        exx = jnp.where(vm.c, exx, 0.0)
        eyy = jnp.where(vm.c, eyy, 0.0)
        exy = jnp.where(vm.v, exy, 0.0)
        return grad_V, exx, eyy, exy

    def masked_momentum(P, txx, tyy, txy, rho_gx, rho_gy, Vy=None):
        """ϕ-weighted derivatives (masked MiniKernels) + face validity.

        With ``free_surface`` and a finite dt, adds the masked stabilization
        term Vy·∂(ϕρg)/∂y·θ·dt to the y-momentum (reference variational
        compute_Vy!, variational_stokes/VelocityKernels.jl:332-404). This is
        the piston-mode damper: with an open (masked) surface, rigid vertical
        column motion is viscously undamped in pseudo-time and the plain
        scheme sustains a P↔Vy oscillation (the reference free-surface
        miniapps run it unstabilized and never meet their own tolerances).
        """
        Pw = P * phi.center
        txxw = txx * phi.center
        tyyw = tyy * phi.center
        txyw = txy * phi.vertex
        gxw = rho_gx * phi.center
        gyw = rho_gy * phi.center
        sxx, sxy = mom_x  # ∂x on x-faces (vertex-x), ∂y (center-y)
        syy, syx = mom_y  # ∂y on y-faces (vertex-y), ∂x (center-x)
        Rx = (
            (txxw[1:, :] - txxw[:-1, :]) * sxx
            + (txyw[1:-1, 1:] - txyw[1:-1, :-1]) * sxy
            - (Pw[1:, :] - Pw[:-1, :]) * sxx
            - 0.5 * (gxw[1:, :] + gxw[:-1, :])
        )
        Ry = (
            (tyyw[:, 1:] - tyyw[:, :-1]) * syy
            + (txyw[1:, 1:-1] - txyw[:-1, 1:-1]) * syx
            - (Pw[:, 1:] - Pw[:, :-1]) * syy
            - 0.5 * (gyw[:, 1:] + gyw[:, :-1])
        )
        if free_surface and Vy is not None:
            # ∂(ϕρg)/∂y between adjacent centers, same spacing family as ∂yP
            drho = (gyw[:, 1:] - gyw[:, :-1]) * syy
            Ry = Ry + Vy[1:-1, 1:-1] * drho * dt
        Rx = jnp.where(vm.vx[1:-1, :], Rx, 0.0)
        Ry = jnp.where(vm.vy[:, 1:-1], Ry, 0.0)
        return Rx, Ry

    class C(NamedTuple):
        Vx: Array
        Vy: Array
        P: Array
        theta: Array
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
        eps_pl: Tuple
        eps_vol_pl: Array
        RP: Array
        err: Array
        err1: Array
        chunk: Array
        hist: Array

    def one_iteration(_, c: C):
        eta_tau = maxloc(c.eta, window=1)
        grad_V, exx, eyy, exy = masked_strain(c.Vx, c.Vy)
        RP, theta = kernels.compute_P(
            c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau
        )
        theta = jnp.where(vm.c, theta, 0.0)
        RP = jnp.where(vm.c, RP, 0.0)
        rho_gx, rho_gy = rho_g_fields(c.P)
        res = update_stresses_center_vertex(
            exx, eyy, exy,
            c.txx, c.tyy, c.txy_c, c.txy_v,
            txx_o, tyy_o, txy_c_o, txy_v_o,
            theta, c.eta, c.lam, c.lam_v, EII_pl,
            material, phase_ratios_center, phase_ratios_vertex,
            lambda_relaxation, dt, theta_dtau,
        )
        txx = jnp.where(vm.c, res.txx, 0.0)
        tyy = jnp.where(vm.c, res.tyy, 0.0)
        txy_c = jnp.where(vm.c, res.txy_c, 0.0)
        txy_v = jnp.where(vm.v, res.txy_v, 0.0)
        P_new = jnp.where(vm.c, res.P_corrected, 0.0)
        eta, eta_v = compute_viscosity_fields(
            c.eta, c.eta_v, material,
            txx, tyy, txy_c,
            jnp.zeros_like(c.eta_v), jnp.zeros_like(c.eta_v), txy_v,
            phase_ratios_center, phase_ratios_vertex,
            mode="tau", relaxation=viscosity_relaxation, cutoff=viscosity_cutoff,
            air_phase=air_phase,
        )
        Rx, Ry = masked_momentum(P_new, txx, tyy, txy_v, rho_gx, rho_gy, Vy=c.Vy)
        etax = 0.5 * (eta_tau[1:, :] + eta_tau[:-1, :])
        etay = 0.5 * (eta_tau[:, 1:] + eta_tau[:, :-1])
        # Rock-fraction step preconditioner (improvement over the reference):
        # the ϕ-weighted momentum row at a face scales ~linearly with the
        # face rock fraction, so near-empty interface faces (ϕ≈cutoff) are
        # arbitrarily slow modes of the reference scheme — its free-surface
        # miniapps never meet their own tolerances. Dividing the pseudo-step
        # by max(ϕ_face, floor) restores uniform spectral bounds; ϕ≡1 is
        # bit-identical to the reference update.
        pcx = jnp.maximum(phi.Vx[1:-1, :], mask_step_floor)
        pcy = jnp.maximum(phi.Vy[:, 1:-1], mask_step_floor)
        # fused masked add + invalid-face hard-zeroing (reference
        # compute_V!:195-215); mask+select instead of slab .at updates —
        # see ops/stencil.py::interior_set
        Vx = interior_set(
            c.Vx,
            jnp.where(
                vm.vx[1:-1, :],
                c.Vx[1:-1, 1:-1] + Rx * etadtau / (etax * pcx),
                0.0,
            ),
        )
        Vy = interior_set(
            c.Vy,
            jnp.where(
                vm.vy[:, 1:-1],
                c.Vy[1:-1, 1:-1] + Ry * etadtau / (etay * pcy),
                0.0,
            ),
        )
        Vx, Vy = flow_bcs((Vx, Vy), flow_bc)
        return c._replace(
            Vx=Vx, Vy=Vy, P=P_new, theta=theta,
            txx=txx, tyy=tyy, txy_c=txy_c, txy_v=txy_v,
            eta=eta, eta_v=eta_v, lam=res.lam, lam_v=res.lam_v,
            tau_II=jnp.where(vm.c, res.tau_II, 0.0),
            eta_vep=res.eta_vep,
            eps_pl=(res.eps_pl_xx, res.eps_pl_yy, res.eps_pl_xy_v),
            eps_vol_pl=res.eps_vol_pl, RP=RP,
        )

    def residual_norms(c: C):
        # Boundary-adjacent rows/columns are excluded like the plain solvers
        # (reference Stokes2D.jl:806-810, Rx[2:end-1, 2:end-1]): no_slip
        # slaves the first interior tangential row (no_slip.jl:11-12,
        # Ax[:,2]=Ax[:,3]/3), so it is not a DOF and its momentum residual
        # never vanishes. The reference variational norm (variational
        # Stokes2D.jl:256-258) keeps those rows and consequently cannot meet
        # its own rel-tolerance at a no-slip wall (its free-surface miniapps
        # run without convergence asserts); we use the plain-solver
        # convention for both paths.
        rho_gx, rho_gy = rho_g_fields(c.P)
        Rx, Ry = masked_momentum(c.P, c.txx, c.tyy, c.txy_v, rho_gx, rho_gy, Vy=c.Vy)
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
        # reduced fori carry: diagnostics are never read by the next
        # iteration (see solvers/stokes2d_vep.py — measured 1.48x there)
        c = _core_template._replace(**dict(zip(_CORE, t)))
        c2 = one_iteration(i, c)
        return tuple(getattr(c2, k) for k in _CORE)

    def body(c: C):
        t = lax.fori_loop(
            0, nout_i - 1, one_iteration_core,
            tuple(getattr(c, k) for k in _CORE),
        )
        c = one_iteration(0, c._replace(**dict(zip(_CORE, t))))
        nRx, nRy, nRP, _, _ = residual_norms(c)
        err = jnp.maximum(jnp.maximum(nRx, nRy), nRP)
        err1 = jnp.where(c.chunk == 0, err, c.err1)
        hist = lax.dynamic_update_index_in_dim(
            c.hist, jnp.stack([nRx, nRy, nRP]), c.chunk, 0
        )
        return c._replace(err=err, err1=err1, chunk=c.chunk + 1, hist=hist)

    init = C(
        Vx=stokes.V.Vx, Vy=stokes.V.Vy, P=stokes.P, theta=stokes.P,
        txx=stokes.tau.xx, tyy=stokes.tau.yy,
        txy_c=stokes.tau.xy_c, txy_v=stokes.tau.xy,
        eta=stokes.viscosity.eta, eta_v=stokes.viscosity.eta_v,
        lam=jnp.zeros_like(stokes.P), lam_v=jnp.zeros_like(stokes.tau.xy),
        tau_II=stokes.tau.II, eta_vep=stokes.viscosity.eta_vep,
        eps_pl=(jnp.zeros_like(stokes.P), jnp.zeros_like(stokes.P),
                jnp.zeros_like(stokes.tau.xy)),
        eps_vol_pl=jnp.zeros_like(stokes.P),
        RP=stokes.R.RP,
        err=jnp.asarray(jnp.inf, dtype), err1=jnp.asarray(1.0, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        hist=jnp.full((max_chunks, 3), jnp.nan, dtype),
    )
    _core_template = init
    c = lax.while_loop(cond, body, init)

    grad_V, exx, eyy, exy = masked_strain(c.Vx, c.Vy)
    nRx, nRy, nRP, Rx, Ry = residual_norms(c)
    from justrelax_tpu.rheology.plasticity import second_invariant_staggered

    def g4(A):
        return (A[:-1, :-1], A[1:, :-1], A[:-1, 1:], A[1:, 1:])

    new_stokes = stokes.replace(
        P=c.P, P0=P0,
        V=stokes.V.replace(Vx=c.Vx, Vy=c.Vy),
        grad_V=grad_V,
        tau=stokes.tau.replace(
            xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c, II=c.tau_II
        ),
        tau_o=stokes.tau_o.replace(xx=c.txx, yy=c.tyy, xy=c.txy_v, xy_c=c.txy_c),
        eps=stokes.eps.replace(
            xx=exx, yy=eyy, xy=exy, xy_c=av_a(exy),
            II=second_invariant_staggered(exx, eyy, g4(exy)),
        ),
        EII_pl=EII_pl
        + second_invariant_staggered(c.eps_pl[0], c.eps_pl[1], g4(c.eps_pl[2])) * dt,
        lam=c.lam, lam_v=c.lam_v,
        viscosity=stokes.viscosity.replace(
            eta=c.eta, eta_v=c.eta_v, eta_vep=c.eta_vep
        ),
        R=stokes.R.replace(RP=c.RP, Rx=Rx, Ry=Ry),
    )
    info = StokesSolveInfo(
        iters=c.chunk * nout_i, err=c.err,
        err_history=jnp.max(c.hist, axis=1),
        norm_Rx=c.hist[:, 0], norm_Ry=c.hist[:, 1], norm_RP=c.hist[:, 2],
    )
    return new_stokes, info
