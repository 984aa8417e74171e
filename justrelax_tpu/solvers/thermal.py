"""Pseudo-transient thermal diffusion solver.

Re-design of the reference solve routine
(/root/reference/src/thermal_diffusion/DiffusionPT_solver.jl:34-319). The PT
iteration runs entirely on device as a ``lax.while_loop`` whose body executes
``nout`` fused flux/update/BC sweeps via ``lax.fori_loop`` and then evaluates
the residual norm — the host only sees the final state (no per-iteration
device→host sync, the reference's per-``nout`` MPI-reduced norm check maps to
a device-side reduction at chunk boundaries).

Convergence: err = ‖ResT‖₂ / √(nx·ny[·nz]) < ϵ, capped at ``iter_max``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from justrelax_tpu.core.coeffs import PTThermalCoeffs
from justrelax_tpu.core.state import ThermalState
from justrelax_tpu.ops import thermal as kernels
from justrelax_tpu.ops.bc import TemperatureBoundaryConditions, thermal_bcs

Array = Any

__all__ = ["heatdiffusion_PT", "ThermalSolveInfo"]


class ThermalSolveInfo(NamedTuple):
    iters: Array  # total PT iterations executed
    err: Array  # final residual norm
    err_history: Array  # per-chunk residual norms (nan-padded)


class _Carry(NamedTuple):
    T: Array
    q: Tuple[Array, ...]
    q2: Tuple[Array, ...]
    err: Array
    chunk: Array
    err_history: Array


def _solve_loop(
    T0,
    q0,
    q20,
    Told,
    H,
    shear_heating,
    adiabatic,
    theta_r_dtau,
    dtau_rho,
    K,
    rho_Cp,
    material,
    P,
    phase_ratios,
    phase_ratios_faces,
    dirichlet,
    bcs,
    inv_flux_di,
    inv_div_di,
    inv_dt,
    eps,
    nout,
    max_chunks,
    halo_exchange,
    reduce_norm,
):
    ni = H.shape
    inv_sqrt_n = 1.0 / math.sqrt(float(jnp.size(H)))

    flux_kwargs = dict(
        K=K, material=material, P=P, phase_ratios_faces=phase_ratios_faces
    )
    cell_kwargs = dict(
        rho_Cp=rho_Cp,
        material=material,
        P=P,
        phase_ratios=phase_ratios,
        adiabatic=adiabatic,
        dirichlet=dirichlet,
    )

    def one_iteration(_, carry):
        T, q, q2 = carry
        q, q2 = kernels.compute_flux(
            q, q2, T, inv_flux_di, theta_r_dtau, bcs.constant_flux, **flux_kwargs
        )
        T = kernels.update_T(
            T, Told, q, H, shear_heating, inv_dt, inv_div_di, dtau_rho, **cell_kwargs
        )
        T = thermal_bcs(T, bcs)
        if halo_exchange is not None:
            T = halo_exchange(T)
        return (T, q, q2)

    def cond(c: _Carry):
        return (c.err > eps) & (c.chunk < max_chunks)

    def body(c: _Carry):
        def one_iteration_core(i, tq):
            # q2 (the un-relaxed physical flux) is only read by the
            # chunk-end residual; keep it out of the fori carry (XLA
            # then also elides its computation in-loop) and produce it
            # with one full final iteration — same pattern as
            # solvers/stokes2d_vep.py
            T2, q2_, _ = one_iteration(i, (tq[0], tq[1], c.q2))
            return (T2, q2_)

        T, q = lax.fori_loop(0, nout - 1, one_iteration_core, (c.T, c.q))
        T, q, q2 = one_iteration(0, (T, q, c.q2))
        res = kernels.check_res(
            T, Told, q2, H, shear_heating, inv_dt, inv_div_di, **cell_kwargs
        )
        if reduce_norm is not None:
            err = reduce_norm(res)
        else:
            err = jnp.linalg.norm(res.ravel()) * inv_sqrt_n
        hist = lax.dynamic_update_index_in_dim(c.err_history, err, c.chunk, 0)
        return _Carry(T, q, q2, err, c.chunk + 1, hist)

    dtype = T0.dtype
    init = _Carry(
        T=T0,
        q=q0,
        q2=q20,
        err=jnp.asarray(2.0 * eps, dtype),
        chunk=jnp.asarray(0, jnp.int32),
        err_history=jnp.full((max_chunks,), jnp.nan, dtype),
    )
    final = lax.while_loop(cond, body, init)
    return final


@partial(
    jax.jit,
    static_argnames=(
        "thermal_bc",
        "geometry",
        "iter_max",
        "nout",
        "halo_exchange",
        "reduce_norm",
    ),
)
def heatdiffusion_PT(
    thermal: ThermalState,
    pt_thermal: PTThermalCoeffs,
    thermal_bc: TemperatureBoundaryConditions,
    dt: float,
    geometry,
    K: Optional[Array] = None,
    rho_Cp: Optional[Array] = None,
    material=None,
    P: Optional[Array] = None,
    phase_ratios: Optional[Array] = None,
    phase_ratios_faces=None,
    dirichlet=None,
    iter_max: int = 50_000,
    nout: int = 1_000,
    halo_exchange=None,
    reduce_norm=None,
) -> Tuple[ThermalState, ThermalSolveInfo]:
    """Solve one implicit timestep of the heat equation with PT iterations.

    Parameters mirror the reference's two entry points: pass ``K``+``rho_Cp``
    center arrays, or a ``material`` (with optional ``P`` and phase ratios).
    ``halo_exchange``/``reduce_norm`` are injected by the distributed layer.

    Returns the updated :class:`ThermalState` (T, Told, ΔT, fluxes, ResT) and
    a :class:`ThermalSolveInfo`.
    """
    ndim = thermal.T.ndim
    if hasattr(geometry, "inv_flux_di"):  # nonuniform vector-spacing grid
        inv_flux_di = tuple(jnp.asarray(a) for a in geometry.inv_flux_di)
        inv_div_di = tuple(jnp.asarray(a) for a in geometry.inv_div_di)
    else:
        inv_flux_di = inv_div_di = tuple(1.0 / d for d in geometry.di)
    inv_dt = 1.0 / dt
    nout = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout)))

    Told = thermal.T
    q0 = (thermal.qTx, thermal.qTy) + ((thermal.qTz,) if ndim == 3 else ())
    q20 = (thermal.qTx2, thermal.qTy2) + ((thermal.qTz2,) if ndim == 3 else ())

    final = _solve_loop(
        thermal.T,
        q0,
        q20,
        Told,
        thermal.H,
        thermal.shear_heating,
        thermal.adiabatic,
        pt_thermal.theta_r_dtau,
        pt_thermal.dtau_rho,
        K,
        rho_Cp,
        material,
        P,
        phase_ratios,
        phase_ratios_faces,
        dirichlet,
        thermal_bc,
        inv_flux_di,
        inv_div_di,
        inv_dt,
        pt_thermal.eps,
        nout,
        max_chunks,
        halo_exchange,
        reduce_norm,
    )

    res = kernels.check_res(
        final.T,
        Told,
        final.q2,
        thermal.H,
        thermal.shear_heating,
        inv_dt,
        inv_div_di,
        rho_Cp=rho_Cp,
        material=material,
        P=P,
        phase_ratios=phase_ratios,
        adiabatic=thermal.adiabatic,
        dirichlet=dirichlet,
    )
    dT = final.T - Told

    new_thermal = thermal.replace(
        T=final.T,
        Told=Told,
        dT=dT,
        qTx=final.q[0],
        qTy=final.q[1],
        qTx2=final.q2[0],
        qTy2=final.q2[1],
        qTz=final.q[2] if ndim == 3 else None,
        qTz2=final.q2[2] if ndim == 3 else None,
        ResT=res,
    )
    info = ThermalSolveInfo(
        iters=final.chunk * nout, err=final.err, err_history=final.err_history
    )
    return new_thermal, info
