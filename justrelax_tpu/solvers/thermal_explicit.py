"""Legacy explicit thermal diffusion + upwind advection (1D/2D/3D).

Functional equivalent of the reference's unexported legacy module
(/root/reference/src/thermal_diffusion/DiffusionExplicit.jl): a
``ThermalParameters(K, ρCp)`` container holding the diffusivity κ = K/ρCp, a
forward-Euler explicit diffusion step (``@parallel compute_flux!`` with
arithmetic face-averaged κ → ``advect_T!`` divergence → ``@inn(T) += dT_dt·dt``,
DiffusionExplicit.jl:198-360), the optional first-order upwind advection term
built from cell-centered velocities (DiffusionExplicit.jl:306-326), and the
1D accelerated-PT diffusion solver (DiffusionExplicit.jl:56-163).

JAX-native re-design notes:

- the reference computes fluxes between interior nodes only and leaves the
  boundary rows to ``thermal_bcs!``; here fluxes are vectorized slices of the
  ghosted ``T`` array (shape ``ni+2`` as everywhere in this package), so
  boundary-face fluxes consistently see the ghost values the BC pass wrote
  (no-flux mirror ⇒ zero boundary flux, Dirichlet ghost ⇒ exact face value) —
  the same convention the validated PT solver (solvers/thermal.py) uses;
- the per-element upwind branch becomes a branchless ``jnp.where``;
- everything is jittable; the time loop stays user-side like the reference
  miniapps.

Supports uniform and nonuniform (vector-spacing) grids through the
``inv_flux_di`` / ``inv_div_di`` spacing families of core/grid.py.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from justrelax_tpu.core.state import ThermalState
from justrelax_tpu.ops.bc import TemperatureBoundaryConditions, thermal_bcs
from justrelax_tpu.ops.stencil import av_a

Array = Any

__all__ = [
    "ThermalParameters",
    "stable_dt_explicit",
    "explicit_diffusion_step",
    "solve_explicit",
    "solve_pt_1d",
]


class ThermalParameters(NamedTuple):
    """κ = K/ρCp at cell centers (reference ThermalParameters struct,
    DiffusionExplicit.jl:7-23, which divides K by ρCp in-place)."""

    kappa: Array

    @classmethod
    def make(cls, K: Array, rhoCp: Array) -> "ThermalParameters":
        return cls(kappa=jnp.asarray(K) / jnp.asarray(rhoCp))


def stable_dt_explicit(params: ThermalParameters, di: Tuple[float, ...]) -> float:
    """Forward-Euler stability bound dt ≤ min(di)²/κ_max/(2·ndim·safety)."""
    ndim = params.kappa.ndim
    return float(min(di)) ** 2 / float(jnp.max(params.kappa)) / (2.1 * ndim)


def _edge_pad(A: Array, axis: int) -> Array:
    pads = [(1, 1) if a == axis else (0, 0) for a in range(A.ndim)]
    return jnp.pad(A, pads, mode="edge")


def _face_kappa(kappa: Array) -> Tuple[Array, ...]:
    """Arithmetic face averages of κ, edge-replicated at domain faces
    (reference ``@av_xi(κ)`` on the interior + ghost-consistent edges)."""
    out = []
    for axis in range(kappa.ndim):
        kp = _edge_pad(kappa, axis)
        lo = tuple(slice(0, -1) if a == axis else slice(None) for a in range(kappa.ndim))
        hi = tuple(slice(1, None) if a == axis else slice(None) for a in range(kappa.ndim))
        out.append(0.5 * (kp[lo] + kp[hi]))
    return tuple(out)


def _interior_slab(T: Array, axis: int, sl: slice) -> Array:
    """T sliced by ``sl`` along ``axis`` and ghost-stripped transversally."""
    idx = tuple(sl if a == axis else slice(1, -1) for a in range(T.ndim))
    return T[idx]


def _diffusive_fluxes(T: Array, kappa_faces, inv_flux_di):
    """q_axis = −κ_face ∂T/∂axis on all (n_axis+1) cell faces."""
    q = []
    for axis in range(T.ndim):
        dT = _interior_slab(T, axis, slice(1, None)) - _interior_slab(
            T, axis, slice(0, -1)
        )
        q.append(-kappa_faces[axis] * dT * inv_flux_di[axis])
    return tuple(q)


def _div(q, inv_div_di):
    out = 0.0
    for axis in range(len(q)):
        lo = tuple(slice(0, -1) if a == axis else slice(None) for a in range(len(q)))
        hi = tuple(slice(1, None) if a == axis else slice(None) for a in range(len(q)))
        out = out + (q[axis][hi] - q[axis][lo]) * inv_div_di[axis]
    return out


def _center_velocities(V: Tuple[Array, ...]) -> Tuple[Array, ...]:
    """Cell-centered velocity from the staggered components (Vx has shape
    (nx+1, ny+2[, nz+2]) etc.: average the two straddling faces, strip the
    transverse ghost rows)."""
    ndim = len(V)
    out = []
    for axis, Vc in enumerate(V):
        lo = tuple(
            slice(0, -1) if a == axis else slice(1, -1) for a in range(ndim)
        )
        hi = tuple(
            slice(1, None) if a == axis else slice(1, -1) for a in range(ndim)
        )
        out.append(0.5 * (Vc[lo] + Vc[hi]))
    return tuple(out)


def _upwind_advection(T: Array, V: Tuple[Array, ...], inv_flux_di):
    """First-order upwind −V·∇T at cell centers (reference advect_T! upwind
    variant, DiffusionExplicit.jl:306-326): donor-cell differences picked by
    the velocity sign, branchless."""
    ndim = T.ndim
    Vc = _center_velocities(V)
    adv = 0.0
    for axis in range(ndim):
        T_c = _interior_slab(T, axis, slice(1, -1))
        T_m = _interior_slab(T, axis, slice(0, -2))
        T_p = _interior_slab(T, axis, slice(2, None))
        inv_lo = _donor_spacing(inv_flux_di[axis], axis, ndim, "lo")
        inv_hi = _donor_spacing(inv_flux_di[axis], axis, ndim, "hi")
        dm = (T_c - T_m) * inv_lo
        dp = (T_p - T_c) * inv_hi
        v = Vc[axis]
        adv = adv + jnp.where(v > 0, v * dm, 0.0) + jnp.where(v < 0, v * dp, 0.0)
    return -adv


def _donor_spacing(inv_face, axis: int, ndim: int, side: str):
    """Per-cell upwind spacing: uniform grids pass a scalar through;
    nonuniform vertex-family spacings live on the n+1 faces, so the donor
    side's face spacing is sliced to the n cells."""
    if not hasattr(inv_face, "ndim") or inv_face.ndim == 0:
        return inv_face
    lo = tuple(slice(0, -1) if a == axis else slice(None) for a in range(inv_face.ndim))
    hi = tuple(slice(1, None) if a == axis else slice(None) for a in range(inv_face.ndim))
    return inv_face[lo] if side == "lo" else inv_face[hi]


def _spacings(geometry):
    """(inv_flux_di, inv_div_di) for uniform Geometry or NonuniformGeometry
    (same dispatch as solvers/thermal.py:170-175)."""
    if hasattr(geometry, "inv_flux_di"):
        inv_flux_di = tuple(jnp.asarray(a) for a in geometry.inv_flux_di)
        inv_div_di = tuple(jnp.asarray(a) for a in geometry.inv_div_di)
    else:
        inv_flux_di = inv_div_di = tuple(1.0 / d for d in geometry.di)
    return inv_flux_di, inv_div_di


def explicit_diffusion_step(
    thermal: ThermalState,
    params: ThermalParameters,
    geometry,
    bcs: TemperatureBoundaryConditions,
    dt,
    V: Optional[Tuple[Array, ...]] = None,
) -> ThermalState:
    """One forward-Euler step: Told ← T; q = −κ∇T; dT_dt = −∇·q (− V·∇T
    upwind if ``V`` given); T_inn += dT_dt·dt; thermal BCs.

    Mirrors reference solve! 2D/3D (DiffusionExplicit.jl:341-395 and the 3D
    twins at :535-720); returns a new ThermalState with ΔT/dT_dt/q filled.
    """
    inv_flux_di, inv_div_di = _spacings(geometry)
    T = thermal.T
    Told = T
    kf = _face_kappa(params.kappa)
    q = _diffusive_fluxes(T, kf, inv_flux_di)
    dT_dt = -_div(q, inv_div_di)
    if V is not None:
        dT_dt = dT_dt + _upwind_advection(T, V, inv_flux_di)
    interior = tuple(slice(1, -1) for _ in range(T.ndim))
    T = T.at[interior].add(dT_dt * dt)
    T = thermal_bcs(T, bcs)
    new = thermal.replace(
        T=T, Told=Told, dT=T - Told, dT_dt=dT_dt, qTx=q[0], qTy=q[1]
    )
    if len(q) == 3:
        new = new.replace(qTz=q[2])
    return new


def solve_explicit(
    thermal: ThermalState,
    params: ThermalParameters,
    geometry,
    bcs: TemperatureBoundaryConditions,
    dt,
    nt: int,
    V: Optional[Tuple[Array, ...]] = None,
) -> ThermalState:
    """``nt`` explicit steps under ``lax.fori_loop`` (device-resident loop)."""

    def body(_, th):
        return explicit_diffusion_step(th, params, geometry, bcs, dt, V=V)

    return lax.fori_loop(0, nt, body, thermal)


class PT1DResult(NamedTuple):
    T: Array
    err: Array
    iters: Array


def solve_pt_1d(
    T: Array,
    K: Array,
    rhoCp: Array,
    dx: float,
    dt,
    bcs: TemperatureBoundaryConditions,
    CFL: float = 0.95,
    Re: float = 3.0 * jnp.pi,
    eps: float = 1.0e-8,
    iter_max: int = 50_000,
    nout: int = 100,
) -> PT1DResult:
    """1D accelerated-PT diffusion solve of one implicit step
    (reference ThermalDiffusion1D module, DiffusionExplicit.jl:56-163).

    ``T`` is ghosted (nx+2,); K, ρCp at the nx cell centers. The PT
    relaxation uses the same θr_dτ/dτ_ρ coefficient family as the 2D/3D PT
    solver (core/coeffs.py): Vpdτ = CFL·dx, Re_T = π+√(π²+ρCp·L²/(K·dt)).
    """
    T = jnp.asarray(T)
    K = jnp.asarray(K)
    rhoCp = jnp.asarray(rhoCp)
    nx = K.shape[0]
    L = nx * dx
    Vpdt = CFL * dx
    ReT = jnp.pi + jnp.sqrt(jnp.pi**2 + rhoCp * L**2 / (K * dt))
    theta_r_dt = L / Vpdt / ReT  # (nx,)
    dtau_rho = Vpdt * L / ReT / K  # (nx,)
    inv_dx = 1.0 / dx
    Told = T
    qTx = jnp.zeros((nx + 1,), T.dtype)
    Kp = jnp.pad(K, (1, 1), mode="edge")
    Kf = 0.5 * (Kp[:-1] + Kp[1:])  # face-averaged conductivity (nx+1,)
    thp = jnp.pad(theta_r_dt, (1, 1), mode="edge")
    thr_f = 0.5 * (thp[:-1] + thp[1:])

    def fluxes(T, qTx):
        dT = (T[1:] - T[:-1]) * inv_dx
        # PT-relaxed flux (reference compute_flux! 1D, :56-61) + true flux
        qTx = (qTx * thr_f - Kf * dT) / (1.0 + thr_f)
        qTx2 = -Kf * dT
        return qTx, qTx2

    def one_iter(c):
        T, qTx, err, it = c
        qTx, _ = fluxes(T, qTx)
        dTdt = -(qTx[1:] - qTx[:-1]) * inv_dx - rhoCp * (T[1:-1] - Told[1:-1]) / dt
        T = T.at[1:-1].add(dTdt * dtau_rho / rhoCp)
        T = _bcs_1d(T, bcs)
        return T, qTx, err, it + 1

    def residual(T, qTx):
        _, qTx2 = fluxes(T, qTx)
        res = -rhoCp * (T[1:-1] - Told[1:-1]) / dt - (qTx2[1:] - qTx2[:-1]) * inv_dx
        return jnp.linalg.norm(res) / jnp.sqrt(res.size)

    def cond(c):
        _, _, err, it = c
        return (err > eps) & (it < iter_max)

    def body(c):
        c = lax.fori_loop(0, nout, lambda _, cc: one_iter(cc), c)
        T, qTx, _, it = c
        return (T, qTx, residual(T, qTx), it)

    init = (T, qTx, jnp.asarray(jnp.inf, T.dtype), jnp.asarray(0, jnp.int32))
    T, qTx, err, iters = lax.while_loop(cond, body, init)
    return PT1DResult(T=T, err=err, iters=iters)


def _bcs_1d(T: Array, bcs: TemperatureBoundaryConditions) -> Array:
    """1D ghost-cell BCs (left/right faces only)."""
    cv, nf = bcs.constant_value, bcs.no_flux
    from justrelax_tpu.ops.bc import Faces

    if Faces.active(cv.left):
        T = T.at[0].set(2.0 * cv.left - T[1])
    if Faces.active(cv.right):
        T = T.at[-1].set(2.0 * cv.right - T[-2])
    if Faces.on(nf.left):
        T = T.at[0].set(T[1])
    if Faces.on(nf.right):
        T = T.at[-1].set(T[-2])
    return T
