"""Variational (embedded free-surface) APT Stokes solver, 3D.

Masked 3D twin of :mod:`justrelax_tpu.solvers.stokes2d_variational`
(reference ``solve_VariationalStokes!`` 3D driver,
/root/reference/src/variational_stokes/Stokes3D.jl): every kernel is gated
by the :class:`~justrelax_tpu.ops.rock_ratio.RockRatio3D` — air carries no
equations, stencil differences weight operands by the local rock fraction
(masked MiniKernels), invalid faces are hard-zeroed, and residual norms
count only rock nodes. Visco-elastic rheology (the 3D fused VEP
plastic pass is tracked for the next round; the 2D fused kernel is
ops/stokes_vep.py).
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
from justrelax_tpu.ops import stokes3d as k3
from justrelax_tpu.ops.bc import VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.rock_ratio import RockRatio3D, valid_masks_3d
from justrelax_tpu.ops.stencil import interior_set, maxloc
from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.solvers.stokes2d import StokesSolveInfo, _norm

Array = Any

__all__ = ["solve_variational_3d"]


@partial(
    jax.jit,
    static_argnames=("geometry", "flow_bc", "iter_max", "nout"),
)
def solve_variational_3d(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    rho_g: Tuple[Array, Array, Array],
    G: Array,
    K: Array,
    phi: RockRatio3D,
    dt,
    iter_max: int = 50_000,
    nout: int = 500,
) -> Tuple[StokesState, StokesSolveInfo]:
    nx, ny, nz = stokes.P.shape
    # nonuniform vector-spacing families (reference Grid.jl:262-316)
    inv_di, inv_di_v, mom_spacings = k3.spacing_families_3d(geometry)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    dtype = stokes.P.dtype

    vm = valid_masks_3d(phi)
    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    P0, Q = stokes.P0, stokes.Q
    tau_o = (
        stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.zz,
        stokes.tau_o.yz, stokes.tau_o.xz, stokes.tau_o.xy,
    )
    fx, fy, fz = rho_g
    if mom_spacings is None:
        _dx, _dy, _dz = inv_di
        _dxv, _dyv, _dzv = inv_di
    else:
        (_dxv, _dyv, _dzv), (_dx, _dy, _dz) = mom_spacings

    def masked_strain(Vx, Vy, Vz):
        grad_V = jnp.where(vm.c, k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di), 0.0)
        exx, eyy, ezz, eyz, exz, exy = k3.compute_strain_rate_3d(
            grad_V, Vx, Vy, Vz, inv_di, inv_di_v
        )
        return (
            grad_V,
            jnp.where(vm.c, exx, 0.0),
            jnp.where(vm.c, eyy, 0.0),
            jnp.where(vm.c, ezz, 0.0),
            jnp.where(vm.yz, eyz, 0.0),
            jnp.where(vm.xz, exz, 0.0),
            jnp.where(vm.xy, exy, 0.0),
        )

    def masked_momentum(P, tau):
        """ϕ-weighted derivatives + face validity (masked MiniKernels)."""
        txx, tyy, tzz, tyz, txz, txy = tau
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

    class C(NamedTuple):
        V: Tuple
        P: Array
        tau: Tuple
        RP: Array
        R: Tuple
        err: Array
        err1: Array
        chunk: Array
        hist: Array

    def one_iteration(_, c: C):
        Vx, Vy, Vz = c.V
        grad_V, exx, eyy, ezz, eyz, exz, exy = masked_strain(Vx, Vy, Vz)
        RP, P = compute_P(c.P, P0, grad_V, Q, eta, K, G, dt, r, theta_dtau)
        P = jnp.where(vm.c, P, 0.0)
        RP = jnp.where(vm.c, RP, 0.0)
        tau = k3.compute_tau_ve_3d(
            c.tau, tau_o, (exx, eyy, ezz, eyz, exz, exy), eta, G, theta_dtau, dt
        )
        txx, tyy, tzz, tyz, txz, txy = tau
        tau = (
            jnp.where(vm.c, txx, 0.0),
            jnp.where(vm.c, tyy, 0.0),
            jnp.where(vm.c, tzz, 0.0),
            jnp.where(vm.yz, tyz, 0.0),
            jnp.where(vm.xz, txz, 0.0),
            jnp.where(vm.xy, txy, 0.0),
        )
        Rx, Ry, Rz = masked_momentum(P, tau)
        etax = 0.5 * (eta_tau[1:, :, :] + eta_tau[:-1, :, :])
        etay = 0.5 * (eta_tau[:, 1:, :] + eta_tau[:, :-1, :])
        etaz = 0.5 * (eta_tau[:, :, 1:] + eta_tau[:, :, :-1])
        # fused masked add + invalid-face hard-zeroing (reference
        # compute_V! masked form); mask+select instead of slab .at updates —
        # see ops/stencil.py::interior_set
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
        return C(
            V=(Vx, Vy, Vz), P=P, tau=tau, RP=RP, R=(Rx, Ry, Rz),
            err=c.err, err1=c.err1, chunk=c.chunk, hist=c.hist,
        )

    def norms(c: C):
        Rx, Ry, Rz = c.R
        nRx = _norm(Rx[1:-1, 1:-1, 1:-1]) / ((nx - 2) * (ny - 1) * (nz - 1))
        nRy = _norm(Ry[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 2) * (nz - 1))
        nRz = _norm(Rz[1:-1, 1:-1, 1:-1]) / ((nx - 1) * (ny - 1) * (nz - 2))
        nRP = _norm(c.RP) / (nx * ny * nz)
        return nRx, nRy, nRz, nRP

    def cond(c: C):
        not_conv = ((c.err / c.err1) > eps_rel) & (c.err > eps_abs)
        return (c.chunk < 1) | (not_conv & (c.chunk < max_chunks))

    _CORE = ("V", "P", "tau")

    def one_iteration_core(i, t):
        # residuals out of the fori carry (see solvers/stokes2d_vep.py)
        c = _core_template._replace(**dict(zip(_CORE, t)))
        c2 = one_iteration(i, c)
        return tuple(getattr(c2, k) for k in _CORE)

    def body(c: C):
        t = lax.fori_loop(
            0, nout_i - 1, one_iteration_core,
            tuple(getattr(c, k) for k in _CORE),
        )
        c = one_iteration(0, c._replace(**dict(zip(_CORE, t))))
        nRx, nRy, nRz, nRP = norms(c)
        err = jnp.max(jnp.stack([nRx, nRy, nRz, nRP]))
        err1 = jnp.where(c.chunk == 0, err, c.err1)
        hist = lax.dynamic_update_index_in_dim(
            c.hist, jnp.stack([nRx, nRy, nRz, nRP]), c.chunk, 0
        )
        return c._replace(err=err, err1=err1, chunk=c.chunk + 1, hist=hist)

    init = C(
        V=(stokes.V.Vx, stokes.V.Vy, stokes.V.Vz),
        P=stokes.P,
        tau=(
            stokes.tau.xx, stokes.tau.yy, stokes.tau.zz,
            stokes.tau.yz, stokes.tau.xz, stokes.tau.xy,
        ),
        RP=stokes.R.RP,
        R=(stokes.R.Rx, stokes.R.Ry, stokes.R.Rz),
        err=jnp.asarray(jnp.inf, dtype),
        err1=jnp.asarray(1.0, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        hist=jnp.full((max_chunks, 4), jnp.nan, dtype),
    )
    _core_template = init
    c = lax.while_loop(cond, body, init)

    txx, tyy, tzz, tyz, txz, txy = c.tau
    tau_II = k3.tensor_invariant_staggered_3d(txx, tyy, tzz, tyz, txz, txy)
    new_stokes = stokes.replace(
        P=c.P,
        V=stokes.V.replace(Vx=c.V[0], Vy=c.V[1], Vz=c.V[2]),
        tau=stokes.tau.replace(
            xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy, II=tau_II
        ),
        tau_o=stokes.tau_o.replace(
            xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy
        ),
        R=stokes.R.replace(RP=c.RP, Rx=c.R[0], Ry=c.R[1], Rz=c.R[2]),
        viscosity=stokes.viscosity.replace(eta_tau=eta_tau),
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
