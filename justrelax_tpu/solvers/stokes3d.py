"""APT visco-elastic Stokes solver, 3D.

Device-resident chunked PT loop mirroring the reference 3D driver
(/root/reference/src/stokes/Stokes3D.jl:25-190): divergence → compressible
pressure → strain rate → VE stress (edge shear components) → fused
residual+velocity update → BCs. Residual norms every ``nout``
(3D convention: ‖R‖₂ / count, Stokes3D.jl:131-146).
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
from justrelax_tpu.ops.stencil import maxloc
from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.solvers.stokes2d import StokesSolveInfo, _norm

Array = Any

__all__ = ["solve_ve_3d"]


@partial(
    jax.jit,
    static_argnames=("geometry", "flow_bc", "iter_max", "nout", "mean_free_RP",
                     "boundary_shear"),
)
def solve_ve_3d(
    stokes: StokesState,
    pt_stokes: PTStokesCoeffs,
    geometry,
    flow_bc: VelocityBoundaryConditions,
    rho_g: Tuple[Array, Array, Array],
    G: Array,
    K: Array,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
    mean_free_RP: bool = False,
    boundary_shear: bool = False,
    alpha_dT=None,
) -> Tuple[StokesState, StokesSolveInfo]:
    """Visco-elastic (compressible) APT Stokes solve, one physical timestep.

    ``mean_free_RP`` deflates the constant pressure-nullspace mode: with
    velocity imposed on every boundary, discretely incompatible boundary data
    (nonzero net flux, e.g. the Burstedde manufactured solution sampled at
    cell midpoints) otherwise makes P drift indefinitely and the continuity
    residual stall."""
    nx, ny, nz = stokes.P.shape
    # nonuniform vector-spacing support (reference Grid.jl:262-316 _di
    # variants): center family for divergence/normal strains, vertex family
    # for edge shear strains, mixed bundle for the momentum update
    inv_di, inv_di_v, mom_spacings = k3.spacing_families_3d(geometry)
    r, theta_dtau, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))
    dtype = stokes.P.dtype

    eta = stokes.viscosity.eta
    eta_tau = maxloc(eta, window=1)
    P0, Q = stokes.P0, stokes.Q
    tau_o = (
        stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.zz,
        stokes.tau_o.yz, stokes.tau_o.xz, stokes.tau_o.xy,
    )
    fx, fy, fz = rho_g

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
        grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
        if mean_free_RP:
            grad_V = grad_V - jnp.mean(grad_V)
        RP, P = compute_P(c.P, P0, grad_V, Q, eta, K, G, dt, r,
                          theta_dtau, alpha_dT=alpha_dT)
        eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di, inv_di_v)
        tau = k3.compute_tau_ve_3d(c.tau, tau_o, eps, eta, G, theta_dtau, dt, boundary_shear=boundary_shear)
        Vx, Vy, Vz, Rx, Ry, Rz = k3.compute_V_3d(
            Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, etadtau, inv_di,
            spacings=mom_spacings,
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
    new_tau = stokes.tau.replace(
        xx=txx, yy=tyy, zz=tzz, yz=tyz, xz=txz, xy=txy, II=tau_II
    )
    new_stokes = stokes.replace(
        P=c.P,
        V=stokes.V.replace(Vx=c.V[0], Vy=c.V[1], Vz=c.V[2]),
        tau=new_tau,
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
