"""Per-kernel-family benchmark chunk functions (T_eff / GUPS harness).

The APT method is memory-bandwidth bound (Räss et al. 2022 GMD; reference
docs/src/man/equations_APT.md:38), so the per-chip figure of merit for every
kernel family is T_eff = A_eff / t_iter — the *necessary* memory traffic of
one fused PT iteration over its wall time — plus grid-updates/s.

Traffic accounting follows the Räss convention: arrays that change every
iteration (the unknowns) are counted read+write (2×N), arrays only read are
counted once (1×N); derived quantities recomputed on the fly (ητ maxloc,
interpolations, strain rates) are NOT counted — recomputation instead of
storage is the design, and counting it would inflate T_eff.

Each family factory returns ``(step, carry, consts, bytes_per_iter, n_cells)``
where ``step(n, carry, consts) -> carry`` advances ``n`` PT iterations with a
*traced* trip count, so one compile serves every point of the slope timing
in bench.py (compiles take seconds to minutes; do not recompile per chunk
size). Bytes are counted at the family's dtype.

Families (matching BASELINE.md "per kernel family" requirement):
  ve2d      — 2D linear/VE APT Stokes iteration (SolCx config), 23·N·4 B
  vep2d     — 2D multi-phase VEP iteration with the fused center+vertex
              stress kernel + τII viscosity (shearband config)
  thermal2d — 2D PT heat diffusion flux/update iteration
  thermal3d — its 3D twin
  ve3d      — 3D VE APT Stokes iteration (slice/pad layout)
  ve3d_canvas  — the same iteration on collocated canvases
  vep3d     — 3D multi-phase VEP iteration (slice/pad layout); with
              ``probe_passes`` it runs only the center or the edge passes of
              the fused return mapping, to split the iteration's time
  vep3d_canvas — the same iteration on collocated canvases

Default sizes are the device-measurement sizes (4096² and 256³): past four
times a 50 MB last-level cache in f32, so no iteration's carry stays cached.
"""

from __future__ import annotations

import math
import time
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

Array = Any

__all__ = ["FAMILIES", "make_family", "measure_family", "stream_bytes",
           "stream_bytes_per_iter"]


def stream_bytes_per_iter(name, factory_kwargs=None):
    """Per-iteration device-memory stream of a family's fori path, in bytes,
    assuming no intermediate leaves the chip's caches.

    T_eff counts only the Räss-convention *necessary* traffic; the XLA
    streaming path moves at least more — every loop-carried array is read
    AND written each iteration (2×) and every chunk-invariant operand
    (explicit consts + closure constants, e.g. phase ratios and moduli
    canvases) is re-read each iteration (1×). Closure constants are
    collected from the jaxpr's constvars. ``(stream bytes / t_iter)`` over
    a copy rate measured on the same device then says how close a path is
    to its byte roofline (≈1) at this traffic; intermediates that XLA
    writes to device memory show up as a share well below 1."""
    step, carry, consts, _, _ = FAMILIES[name](**(factory_kwargs or {}))
    return stream_bytes(step, carry, consts)


def stream_bytes(step, carry, consts):
    """:func:`stream_bytes_per_iter` of an already built family."""

    def leaf_bytes(tree):
        return sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(tree)
            if hasattr(x, "shape") and x.ndim > 0
        )

    closed = jax.make_jaxpr(
        lambda c, k: step(jnp.asarray(2, jnp.int32), c, k)
    )(carry, consts)
    const_arrays = [
        v for v in closed.consts
        if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0
    ]
    return 2 * leaf_bytes(carry) + leaf_bytes(consts) + leaf_bytes(const_arrays)


def measure_family(name, copy_Bs, target_s=0.3, repeats=3,
                   **factory_kwargs):
    """Build, compile and time family ``name`` on the default device.

    Returns the row that ``bench.py`` and ``chip_smoke.py`` print: t_iter
    (median slope, and every repeat), compile seconds, T_eff and GUPS from
    the necessary bytes, and the stream rate (:func:`stream_bytes` over
    t_iter) with its share of ``copy_Bs``, a copy rate measured in the same
    run."""
    from justrelax_tpu.utils.timing import slope_t_iter

    step, carry, consts, bytes_iter, n_cells = FAMILIES[name](
        **factory_kwargs)
    stream = stream_bytes(step, carry, consts)
    t0 = time.perf_counter()
    fn = jax.jit(step).lower(jnp.asarray(10, jnp.int32), carry,
                             consts).compile()
    compile_s = time.perf_counter() - t0
    timing = slope_t_iter(fn, carry, consts, target_s=target_s,
                          repeats=repeats)
    t = max(timing.t_iter, 1e-12)
    return dict(
        n_cells=n_cells, t_iter_us=t * 1e6,
        t_iter_us_repeats=[x * 1e6 for x in timing.slopes], dn=timing.dn,
        compile_s=compile_s, T_eff_GBs=bytes_iter / t / 1e9,
        GUPS=n_cells / t / 1e9, stream_bytes_per_iter=stream,
        stream_GBs=stream / t / 1e9, share_of_copy=stream / t / copy_Bs,
    )


# --------------------------------------------------------------------------
# 2D visco-elastic (SolCx), the flagship single-kernel iteration
# --------------------------------------------------------------------------
def _solcx_setup(nx, ny, dtype):
    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions

    ni = (nx, ny)
    geometry = Geometry(ni, (1.0, 1.0))
    stokes = StokesState.make(ni, dtype=dtype)
    X, Y = geometry.cell_centers_mesh()
    eta = jnp.asarray(np.where(np.asarray(X) <= 0.5, 1.0, 1.0e3), dtype)
    stokes = stokes.replace(viscosity=stokes.viscosity.replace(eta=eta))
    rho_g = (
        jnp.zeros(ni, dtype),
        jnp.asarray(-jnp.sin(jnp.pi * Y) * jnp.cos(jnp.pi * X), dtype),
    )
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    G = jnp.full(ni, jnp.inf, dtype)
    K = jnp.full(ni, jnp.inf, dtype)
    return geometry, stokes, pt, bc, rho_g, G, K


def ve2d(nx=4096, ny=4096, dtype=jnp.float32):
    """One fused VE Stokes PT iteration, SolCx viscosity field.

    Traffic: unknowns (R+W) Vx, Vy, P, τxx, τyy, τxy → 12·N; read-only
    η, ητ, G, K, P0, Q, ρgx, ρgy, τ_o×3 → 11·N. A_eff = 23·N·4 B.
    """
    from justrelax_tpu.ops import stokes as kernels
    from justrelax_tpu.ops.bc import flow_bcs
    from justrelax_tpu.ops.stencil import maxloc

    geometry, stokes, pt, bc, rho_g, G, K = _solcx_setup(nx, ny, dtype)
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    r, theta, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    dt = jnp.asarray(0.1, dtype)

    def step(n, carry, consts):
        P0, Q, eta, G, K, rho_gx, rho_gy = consts
        eta_tau = maxloc(eta, window=1)
        zeros = jnp.zeros_like(P0)
        zeros_v = jnp.zeros((nx + 1, ny + 1), dtype)

        def body(_, c):
            Vx, Vy, P, txx, tyy, txy = c
            grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            RP, P = kernels.compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta)
            exx, eyy, exy = kernels.compute_strain_rate(grad_V, Vx, Vy, inv_dx, inv_dy)
            txx, tyy, txy = kernels.compute_tau_ve(
                txx, tyy, txy, zeros, zeros, zeros_v, exx, eyy, exy, eta, G, theta, dt
            )
            Vx, Vy = kernels.compute_V(
                Vx, Vy, P, txx, tyy, txy, etadtau, rho_gx, rho_gy, eta_tau,
                inv_dx, inv_dy,
            )
            Vx, Vy = flow_bcs((Vx, Vy), bc)
            return (Vx, Vy, P, txx, tyy, txy)

        return lax.fori_loop(0, n, body, carry)

    carry = (
        stokes.V.Vx, stokes.V.Vy, stokes.P,
        stokes.tau.xx, stokes.tau.yy, stokes.tau.xy,
    )
    consts = (stokes.P0, stokes.Q, stokes.viscosity.eta, G, K, rho_g[0], rho_g[1])
    n_cells = nx * ny
    return step, carry, consts, 23 * n_cells * jnp.dtype(dtype).itemsize, n_cells


# --------------------------------------------------------------------------
# 2D multi-phase VEP (shearband config): fused center+vertex stress kernel
# --------------------------------------------------------------------------
def vep2d(n=4096, dtype=jnp.float32):
    """One PT iteration of the flagship multi-phase VEP solve
    (solvers/stokes2d_vep.py one_iteration): ∇V → compressible P → strain
    rate → fused center+vertex return mapping → τII viscosity → V update.

    Traffic (N = nx·ny; vertex arrays counted as N):
      unknowns (R+W): Vx, Vy, θ, τxx, τyy, τxy_c, τxy_v, η, λ, λv → 20·N
      write-only    : τII, η_vep, P, ε_pl×3, ε_vol_pl, RP       →  8·N
      read-only     : τ_o×4, EII, P0, Q, phase_c×2, phase_v×2   → 11·N
    A_eff = 39·N·4 B.
    """
    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops import stokes as kernels
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
    from justrelax_tpu.ops.stencil import maxloc
    from justrelax_tpu.ops.stokes_vep import update_stresses_center_vertex
    from justrelax_tpu.rheology.materials import Material, MaterialStack
    from justrelax_tpu.rheology.viscosity import compute_viscosity_fields

    ni = (n, n)
    geometry = Geometry(ni, (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=8.0e-3)
    material = MaterialStack.make(
        [Material(G=1.0, **common), Material(G=0.5, **common)]
    )
    material = jax.tree.map(
        lambda x: x.astype(dtype) if hasattr(x, "astype") else x, material
    )

    def circle(xs, ys):
        X, Y = np.meshgrid(np.asarray(xs), np.asarray(ys), indexing="ij")
        inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 <= 0.01
        ratios = np.zeros(X.shape + (2,), np.float64)
        ratios[..., 0] = ~inside
        ratios[..., 1] = inside
        return jnp.asarray(ratios, dtype)

    pr_c = circle(xci[0], xci[1])
    pr_v = circle(xvi[0], xvi[1])
    stokes = StokesState.make(ni, dtype=dtype)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(2.1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    xv = jnp.asarray(xvi[0], dtype)
    yv = jnp.asarray(xvi[1], dtype)
    Vx = jnp.broadcast_to(xv[:, None], (n + 1, n + 2)).astype(dtype)
    Vy = jnp.broadcast_to(-yv[None, :], (n + 2, n + 1)).astype(dtype)
    inv_dx, inv_dy = 1.0 / geometry.di[0], 1.0 / geometry.di[1]
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    dt = jnp.asarray(0.25, dtype)

    from justrelax_tpu.rheology.materials import get_bulk_modulus, get_shear_modulus

    K_c = get_bulk_modulus(material, pr_c)
    G_c = get_shear_modulus(material, pr_c)

    class Carry(NamedTuple):
        Vx: Array
        Vy: Array
        theta: Array
        txx: Array
        tyy: Array
        txy_c: Array
        txy_v: Array
        eta: Array
        eta_v: Array
        lam: Array
        lam_v: Array

    def step(n_iter, carry, consts):
        P0, Q, txx_o, tyy_o, txy_c_o, txy_v_o, EII, pr_c, pr_v, K_c, G_c = \
            consts

        def body(_, c):
            eta_tau = maxloc(c.eta, window=1)
            grad_V = kernels.compute_grad_V(c.Vx, c.Vy, inv_dx, inv_dy)
            RP, theta = kernels.compute_P(
                c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau
            )
            exx, eyy, exy = kernels.compute_strain_rate(
                grad_V, c.Vx, c.Vy, inv_dx, inv_dy
            )
            res = update_stresses_center_vertex(
                exx, eyy, exy,
                c.txx, c.tyy, c.txy_c, c.txy_v,
                txx_o, tyy_o, txy_c_o, txy_v_o,
                theta, c.eta, c.lam, c.lam_v, EII,
                material, pr_c, pr_v, 0.2, dt, theta_dtau,
            )
            eta, eta_v = compute_viscosity_fields(
                c.eta, c.eta_v, material,
                res.txx, res.tyy, res.txy_c,
                jnp.zeros_like(c.eta_v), jnp.zeros_like(c.eta_v), res.txy_v,
                pr_c, pr_v, mode="tau", relaxation=1.0e-2,
            )
            Vx, Vy = kernels.compute_V(
                c.Vx, c.Vy, res.P_corrected, res.txx, res.tyy, res.txy_v,
                etadtau, jnp.zeros_like(P0), jnp.zeros_like(P0), eta_tau,
                inv_dx, inv_dy,
            )
            Vx, Vy = flow_bcs((Vx, Vy), bc)
            return Carry(
                Vx=Vx, Vy=Vy, theta=theta,
                txx=res.txx, tyy=res.tyy, txy_c=res.txy_c, txy_v=res.txy_v,
                eta=eta, eta_v=eta_v, lam=res.lam, lam_v=res.lam_v,
            )

        return lax.fori_loop(0, n_iter, body, carry)

    carry = Carry(
        Vx=Vx, Vy=Vy, theta=stokes.P,
        txx=stokes.tau.xx, tyy=stokes.tau.yy,
        txy_c=stokes.tau.xy_c, txy_v=stokes.tau.xy,
        eta=jnp.ones(ni, dtype), eta_v=jnp.ones((n + 1, n + 1), dtype),
        lam=jnp.zeros(ni, dtype), lam_v=jnp.zeros((n + 1, n + 1), dtype),
    )
    # grid-sized operands go in as arguments: captured by the step function
    # they would become program constants, which XLA constant-folds for
    # minutes at 4096²
    consts = (
        stokes.P0, stokes.Q,
        stokes.tau_o.xx, stokes.tau_o.yy, stokes.tau_o.xy_c, stokes.tau_o.xy,
        stokes.EII_pl, pr_c, pr_v, K_c, G_c,
    )
    n_cells = n * n
    return step, carry, consts, 39 * n_cells * jnp.dtype(dtype).itemsize, n_cells


# --------------------------------------------------------------------------
# 2D PT thermal diffusion
# --------------------------------------------------------------------------
def thermal2d(nx=4096, ny=4096, dtype=jnp.float32):
    """One PT heat-diffusion iteration (flux relaxation + damped T update +
    ghost BCs), constant-coefficient variant.

    Traffic: unknowns (R+W) T, qx, qy, q2x, q2y → 10·N; read-only Told, K,
    θr_dτ, dτ_ρ, ρCp, H → 6·N. A_eff = 16·N·4 B.
    """
    from justrelax_tpu.ops import thermal as kernels
    from justrelax_tpu.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs

    ni = (nx, ny)
    li = (100.0e3, 100.0e3)
    di = (li[0] / nx, li[1] / ny)
    inv_di = (1.0 / di[0], 1.0 / di[1])
    from justrelax_tpu.core.coeffs import PTThermalCoeffs

    K = jnp.full(ni, 3.0, dtype)
    rho_Cp = jnp.full(ni, 3.3e6, dtype)
    dt = 1.5e11
    coeffs = PTThermalCoeffs.make(K, rho_Cp, dt, di, li)
    rng = np.random.default_rng(0)
    T = jnp.asarray(1500.0 + 10.0 * rng.normal(size=(nx + 2, ny + 2)), dtype)
    Told = T
    H = jnp.zeros(ni, dtype)
    bcs = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True),
        constant_value=Faces(top=True, bot=True),
    )
    theta_r_dtau = coeffs.theta_r_dtau.astype(dtype)
    dtau_rho = coeffs.dtau_rho.astype(dtype)
    inv_dt = 1.0 / dt

    def step(n, carry, consts):
        Told, K, rho_Cp, H = consts

        def body(_, c):
            T, q, q2 = c
            q, q2 = kernels.compute_flux(
                q, q2, T, inv_di, theta_r_dtau, bcs.constant_flux, K=K
            )
            T = kernels.update_T(
                T, Told, q, H, H, inv_dt, inv_di, dtau_rho, rho_Cp=rho_Cp
            )
            T = thermal_bcs(T, bcs)
            return (T, q, q2)

        return lax.fori_loop(0, n, body, carry)

    qx = jnp.zeros((nx + 1, ny), dtype)
    qy = jnp.zeros((nx, ny + 1), dtype)
    carry = (T, (qx, qy), (qx, qy))
    consts = (Told, K, rho_Cp, H)
    n_cells = nx * ny
    return step, carry, consts, 16 * n_cells * jnp.dtype(dtype).itemsize, n_cells


def thermal3d(n=256, dtype=jnp.float32):
    """One 3D PT heat-diffusion iteration — same kernels as ``thermal2d``
    (ops/thermal.py is dimension-agnostic), 3D shapes.

    Traffic: unknowns (R+W) T, q×3, q2×3 → 14·N; read-only Told, K,
    θr_dτ, dτ_ρ, ρCp, H → 6·N. A_eff = 20·N·4 B (f32).
    """
    from justrelax_tpu.core.coeffs import PTThermalCoeffs
    from justrelax_tpu.ops import thermal as kernels
    from justrelax_tpu.ops.bc import Faces, TemperatureBoundaryConditions, thermal_bcs

    ni = (n, n, n)
    li = (100.0e3,) * 3
    di = tuple(l / n for l in li)
    inv_di = tuple(1.0 / d for d in di)
    K = jnp.full(ni, 3.0, dtype)
    rho_Cp = jnp.full(ni, 3.3e6, dtype)
    dt = 1.5e11
    coeffs = PTThermalCoeffs.make(K, rho_Cp, dt, di, li)
    rng = np.random.default_rng(0)
    T = jnp.asarray(1500.0 + 10.0 * rng.normal(size=tuple(x + 2 for x in ni)),
                    dtype)
    Told = T
    H = jnp.zeros(ni, dtype)
    bcs = TemperatureBoundaryConditions(
        no_flux=Faces(left=True, right=True, front=True, back=True),
        constant_value=Faces(top=True, bot=True),
    )
    theta_r_dtau = coeffs.theta_r_dtau.astype(dtype)
    dtau_rho = coeffs.dtau_rho.astype(dtype)
    inv_dt = 1.0 / dt

    def step(n_iter, carry, consts):
        Told, K, rho_Cp, H = consts

        def body(_, c):
            T, q, q2 = c
            q, q2 = kernels.compute_flux(
                q, q2, T, inv_di, theta_r_dtau, bcs.constant_flux, K=K
            )
            T = kernels.update_T(
                T, Told, q, H, H, inv_dt, inv_di, dtau_rho, rho_Cp=rho_Cp
            )
            T = thermal_bcs(T, bcs)
            return (T, q, q2)

        return lax.fori_loop(0, n_iter, body, carry)

    qx = jnp.zeros((n + 1, n, n), dtype)
    qy = jnp.zeros((n, n + 1, n), dtype)
    qz = jnp.zeros((n, n, n + 1), dtype)
    carry = (T, (qx, qy, qz), (qx, qy, qz))
    consts = (Told, K, rho_Cp, H)
    n_cells = n * n * n
    return step, carry, consts, 20 * n_cells * jnp.dtype(dtype).itemsize, n_cells


# --------------------------------------------------------------------------
# 3D visco-elastic Stokes
# --------------------------------------------------------------------------
def ve3d(n=256, dtype=jnp.float32):
    """One 3D VE Stokes PT iteration (solvers/stokes3d.py one_iteration).

    Traffic: unknowns (R+W) V×3, P, τ×6 → 20·N; read-only η, ητ, G, K, P0,
    Q, f×3, τ_o×6 → 15·N. A_eff = 35·N·4 B (f32).
    """
    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.ops import stokes3d as k3
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
    from justrelax_tpu.ops.stencil import maxloc
    from justrelax_tpu.ops.stokes import compute_P

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    rng = np.random.default_rng(0)
    eta = jnp.asarray(np.exp(0.3 * rng.normal(size=ni)), dtype)
    Z = jnp.zeros(ni, dtype)
    G = jnp.full(ni, jnp.inf, dtype)
    K = jnp.full(ni, jnp.inf, dtype)
    fz = jnp.asarray(rng.normal(size=ni), dtype)
    dt = jnp.asarray(jnp.inf, dtype)

    def step(n_iter, carry, consts):
        P0, Q, eta, G, K, fx, fy, fz, tau_o = consts
        eta_tau = maxloc(eta, window=1)

        def body(_, c):
            (Vx, Vy, Vz), P, tau = c
            grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
            RP, P = compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt, r, theta_dtau)
            eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
            tau = k3.compute_tau_ve_3d(tau, tau_o, eps, eta, G, theta_dtau, dt)
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(
                Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, etadtau, inv_di
            )
            Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
            return ((Vx, Vy, Vz), P, tau)

        return lax.fori_loop(0, n_iter, body, carry)

    Vx = jnp.zeros((n + 1, n + 2, n + 2), dtype)
    Vy = jnp.zeros((n + 2, n + 1, n + 2), dtype)
    Vz = jnp.zeros((n + 2, n + 2, n + 1), dtype)
    tyz = jnp.zeros((n, n + 1, n + 1), dtype)
    txz = jnp.zeros((n + 1, n, n + 1), dtype)
    txy = jnp.zeros((n + 1, n + 1, n), dtype)
    tau = (Z, Z, Z, tyz, txz, txy)
    carry = ((Vx, Vy, Vz), Z, tau)
    consts = (Z, Z, eta, G, K, Z, Z, fz, tau)
    n_cells = n * n * n
    return step, carry, consts, 35 * n_cells * jnp.dtype(dtype).itemsize, n_cells


def vep3d(n=256, dtype=jnp.float32, probe_passes=None, hoist_params=True):
    """One PT iteration of the 3D multi-phase VEP solve
    (solvers/stokes3d_vep.py one_iteration, ShearBand3D config): maxloc →
    compressible θ → strain rate → fused center+edges return mapping (3
    shear-edge families) → τII viscosity continuation → damped V update +
    free-slip.

    Traffic (N = n³; staggered/edge arrays counted as N):
      unknowns (R+W): V×3, θ, P, τ_c×6, τ_e×3, η, λ, λ_e×3 → 36·N
      write-only    : τII, η_vep, ε_pl 6+3, ε_vol_pl, RP     → 13·N
      read-only     : τ_o 6+3, EII, P0, Q, K, G, phase ratios (c + 3
                      edges, 2 phases) 8·N                   → 22·N
    A_eff = 71·N·4 B.
    """
    import numpy as _np

    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops import stokes3d as k3
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
    from justrelax_tpu.ops.stencil import maxloc
    from justrelax_tpu.ops.stokes import compute_P
    from justrelax_tpu.ops.stokes3d_vep import (
        _inv_II,
        make_vep_params_3d,
        update_stresses_center_edges_3d,
    )
    from justrelax_tpu.rheology.materials import (
        Material,
        MaterialStack,
        get_bulk_modulus,
        get_shear_modulus,
    )
    from justrelax_tpu.rheology.phases import phase_ratios_from_field
    from justrelax_tpu.rheology.viscosity import (
        continuation_linear,
        phase_viscosity,
    )

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2)
    material = MaterialStack.make([
        Material(G=1.0, eta0=1.0, **common),
        Material(G=0.5, eta0=0.1, **common),
    ])
    material = jax.tree.map(
        lambda x: x.astype(dtype) if hasattr(x, "astype") else x, material
    )
    X, Y, Zc = _np.meshgrid(*[_np.asarray(c) for c in geometry.xci], indexing="ij")
    inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Zc - 0.5) ** 2 <= 0.01
    pr = phase_ratios_from_field(jnp.asarray(inside.astype(int)), 2)
    pr = jax.tree.map(lambda x: x.astype(dtype), pr)
    pr_edges = (pr.edge_yz, pr.edge_xz, pr.edge_xy)

    stokes = StokesState.make(ni, dtype=dtype)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.75 / math.sqrt(3.1))
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    dt = jnp.asarray(0.125, dtype)
    K_c = get_bulk_modulus(material, pr.center)
    G_c = get_shear_modulus(material, pr.center)
    xv = jnp.asarray(geometry.xvi[0], dtype)
    zv = jnp.asarray(geometry.xvi[2], dtype)
    Vx = jnp.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2)).astype(dtype)
    Vy = jnp.zeros((n + 2, n + 1, n + 2), dtype)
    Vz = jnp.broadcast_to((-zv)[None, None, :], (n + 2, n + 2, n + 1)).astype(dtype)
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    eta0 = jnp.where(jnp.asarray(inside), 0.1, 1.0).astype(dtype)

    class Carry(NamedTuple):
        V: Any
        theta: Array
        P: Array
        tau_c: Any
        tau_e: Any
        eta: Array
        lam: Array
        lam_e: Any

    def step(n_iter, carry, consts):
        P0, Q, tau_o_c6, tau_o_e3, EII_pl, pr_c, pr_edges, K_c, G_c = consts
        # solver parity: solve_vep_3d hoists the solve-invariants once per
        # solve (ops/stokes3d_vep.py::make_vep_params_3d)
        vp = make_vep_params_3d(
            material, EII_pl, pr_c, pr_edges, tau_o_c6, tau_o_e3
        ) if hoist_params else None

        def body(_, c):
            Vx, Vy, Vz = c.V
            eta_tau = maxloc(c.eta, window=1)
            grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
            RP, theta = compute_P(
                c.theta, P0, grad_V, Q, eta_tau, K_c, G_c, dt, r, theta_dtau
            )
            eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
            res = update_stresses_center_edges_3d(
                eps[:3], eps[3:], c.tau_c, c.tau_e, tau_o_c6, tau_o_e3,
                theta, c.eta, c.lam, c.lam_e, EII_pl,
                material, pr_c, pr_edges, 0.2, dt, theta_dtau,
                probe_passes=probe_passes, params=vp,
            )
            tII = _inv_II(res.tau_c)
            eta_n = phase_viscosity(material, tII, None, pr_c, "tau")
            eta = continuation_linear(eta_n, c.eta, 1.0e-2)
            tau6 = res.tau_c[:3] + res.tau_e
            z = jnp.zeros_like(theta)
            Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(
                Vx, Vy, Vz, res.P_corrected, tau6, z, z, z,
                eta_tau, etadtau, inv_di,
            )
            Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
            return Carry(
                V=(Vx, Vy, Vz), theta=theta, P=res.P_corrected,
                tau_c=res.tau_c, tau_e=res.tau_e, eta=eta,
                lam=res.lam, lam_e=res.lam_e,
            )

        return lax.fori_loop(0, n_iter, body, carry)

    Z = jnp.zeros(ni, dtype)
    tyz = jnp.zeros((n, n + 1, n + 1), dtype)
    txz = jnp.zeros((n + 1, n, n + 1), dtype)
    txy = jnp.zeros((n + 1, n + 1, n), dtype)
    # elastic memory near yield so the plastic branch is active
    txx_o = jnp.full(ni, 1.0, dtype)
    carry = Carry(
        V=(Vx, Vy, Vz), theta=Z, P=Z,
        tau_c=(Z, Z, Z, Z, Z, Z), tau_e=(tyz, txz, txy),
        eta=eta0, lam=Z,
        lam_e=(tyz, txz, txy),
    )
    # grid-sized operands go in as arguments, not as captured constants
    # (see vep2d)
    consts = (Z, Z, (txx_o, -txx_o, Z, Z, Z, Z),
              (tyz, txz, txy), Z, pr.center, pr_edges, K_c, G_c)
    n_cells = n * n * n
    return step, carry, consts, 71 * n_cells * jnp.dtype(dtype).itemsize, n_cells


def ve3d_canvas(n=256, dtype=jnp.float32, lean=False, shift="slice"):
    """Collocated-canvas 3D VE iteration (ops/stokes3d_canvas.py) — the
    roll+mask XLA formulation racing the slice/pad ``ve3d`` family. Same
    35·N·4 B traffic convention (same physics config, same necessary
    traffic) so the two rows are directly comparable.

    ``lean=True`` streams only the physics canvases (η, ητ, fz) and
    re-derives the 11 coefficient canvases inside the loop body (bitwise
    identical; see stokes3d_chunk_canvas_lean). ``shift`` picks the
    neighbor-shift lowering: "slice" (pad, the default) or "roll"
    (concatenate)."""
    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.ops.stencil import maxloc
    from justrelax_tpu.ops.stokes3d_canvas import (
        lean_canvas_consts,
        pack_carry,
        stokes3d_chunk_canvas,
        stokes3d_chunk_canvas_lean,
        ve3d_canvas_coefficients,
    )

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di)
    r, theta_dtau, etadtau = (
        float(pt.r), float(pt.theta_dtau), float(pt.etadtau))
    rng = np.random.default_rng(0)
    eta = jnp.asarray(np.exp(0.3 * rng.normal(size=ni)), dtype)
    fz = jnp.asarray(rng.normal(size=ni), dtype)
    Z3 = jnp.zeros(ni, dtype)
    eta_tau = maxloc(eta, window=1)
    if lean:
        co = lean_canvas_consts(eta, eta_tau, fz=fz)
    else:
        co = ve3d_canvas_coefficients(
            eta, eta_tau, r, theta_dtau, etadtau, fx=Z3, fy=Z3, fz=fz,
        )
    co = jax.tree.map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        co,
    )
    fields = (
        jnp.zeros((n + 1, n + 2, n + 2), dtype),
        jnp.zeros((n + 2, n + 1, n + 2), dtype),
        jnp.zeros((n + 2, n + 2, n + 1), dtype),
        Z3, Z3, Z3, Z3,
        jnp.zeros((n, n + 1, n + 1), dtype),
        jnp.zeros((n + 1, n, n + 1), dtype),
        jnp.zeros((n + 1, n + 1, n), dtype),
    )
    carry = tuple(pack_carry(*fields))

    if lean:
        def step(n_iter, carry, consts):
            return stokes3d_chunk_canvas_lean(
                carry, consts, r, theta_dtau, etadtau, inv_di, n_iter,
                shift=shift)
    else:
        def step(n_iter, carry, consts):
            return stokes3d_chunk_canvas(carry, consts, inv_di, n_iter,
                                         shift=shift)

    n_cells = n * n * n
    return step, carry, co, 35 * n_cells * jnp.dtype(dtype).itemsize, n_cells


def vep3d_canvas(n=256, dtype=jnp.float32):
    """Collocated-canvas 3D VEP iteration (ops/stokes3d_vep_canvas.py) —
    same physics config and 71·N·4 B traffic convention as ``vep3d`` so the
    rows are directly comparable. The return-mapping body is the SAME
    update_stresses_center_edges_3d; only the staggered moves differ
    (canvas rolls+selects vs mixed-shape clamped slices)."""
    import numpy as _np

    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
    from justrelax_tpu.ops.stokes3d_vep_canvas import (
        VEP3DCanvasCarry,
        embed_center,
        embed_edge,
        vep3d_canvas_consts,
        vep3d_chunk_canvas,
    )
    from justrelax_tpu.rheology.materials import Material, MaterialStack
    from justrelax_tpu.rheology.phases import phase_ratios_from_field

    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    inv_di = tuple(1.0 / d for d in geometry.di)
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2)
    material = MaterialStack.make([
        Material(G=1.0, eta0=1.0, **common),
        Material(G=0.5, eta0=0.1, **common),
    ])
    material = jax.tree.map(
        lambda x: x.astype(dtype) if hasattr(x, "astype") else x, material
    )
    X, Y, Zc = _np.meshgrid(*[_np.asarray(c) for c in geometry.xci],
                            indexing="ij")
    inside = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Zc - 0.5) ** 2 <= 0.01
    pr = phase_ratios_from_field(jnp.asarray(inside.astype(int)), 2)
    pr = jax.tree.map(lambda x: x.astype(dtype), pr)
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.75 / math.sqrt(3.1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    dt = jnp.asarray(0.125, dtype)
    xv = jnp.asarray(geometry.xvi[0], dtype)
    zv = jnp.asarray(geometry.xvi[2], dtype)
    Vx = jnp.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2)).astype(dtype)
    Vy = jnp.zeros((n + 2, n + 1, n + 2), dtype)
    Vz = jnp.broadcast_to((-zv)[None, None, :], (n + 2, n + 2, n + 1)).astype(dtype)
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    eta0 = jnp.where(jnp.asarray(inside), 0.1, 1.0).astype(dtype)

    Z = jnp.zeros(ni, dtype)
    tyz = jnp.zeros((n, n + 1, n + 1), dtype)
    txz = jnp.zeros((n + 1, n, n + 1), dtype)
    txy = jnp.zeros((n + 1, n + 1, n), dtype)
    txx_o = jnp.full(ni, 1.0, dtype)
    carry = VEP3DCanvasCarry(
        V=(jnp.pad(Vx, ((0, 1), (0, 0), (0, 0))),
           jnp.pad(Vy, ((0, 0), (0, 1), (0, 0))),
           jnp.pad(Vz, ((0, 0), (0, 0), (0, 1)))),
        P=embed_center(Z), theta=embed_center(Z),
        tau_c=tuple(embed_center(Z) for _ in range(6)),
        tau_e=tuple(embed_edge(t, k) for k, t in enumerate((tyz, txz, txy))),
        eta=embed_center(eta0),
        lam=embed_center(Z),
        lam_e=tuple(embed_edge(t, k) for k, t in enumerate((tyz, txz, txy))),
    )
    co = vep3d_canvas_consts(
        material, (txx_o, -txx_o, Z, Z, Z, Z), (tyz, txz, txy), Z, Z, Z,
        pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy),
    )
    co = jax.tree.map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        co,
    )
    r, theta_dtau, etadtau = pt.r, pt.theta_dtau, pt.etadtau
    kw = dict(dt=dt, r=r, theta_dtau=theta_dtau, etadtau=etadtau,
              lambda_relaxation=0.2, viscosity_relaxation=1.0e-2)

    def step(n_iter, carry, consts):
        return vep3d_chunk_canvas(
            carry, consts, material, inv_di, n_iter, **kw,
        )

    n_cells = n * n * n
    return step, carry, co, 71 * n_cells * jnp.dtype(dtype).itemsize, n_cells


FAMILIES = {
    "ve2d": ve2d,
    "vep2d": vep2d,
    "thermal2d": thermal2d,
    "thermal3d": thermal3d,
    "ve3d": ve3d,
    "ve3d_canvas": ve3d_canvas,
    "vep3d": vep3d,
    "vep3d_canvas": vep3d_canvas,
}


def make_family(name, **kwargs):
    return FAMILIES[name](**kwargs)
