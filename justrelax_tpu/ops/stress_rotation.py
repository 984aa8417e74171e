"""Elastic stress rotation (advection coupling).

Reference: src/stress_rotation/stress_rotation_{grid,particles}.jl. The old
deviatoric stress τ_o must co-rotate with the material between timesteps.
Two routes, as in the reference:

- grid-based Jaumann update at cell centers:
    τ ← τ + dt·(τ·ω − ω·τ)  with ω the xy vorticity at the center
  (the reference's in-place kernel stores only the rotation increment and
  zeroes its advection term — stress_rotation_grid.jl:66-71 — we implement
  the consistent co-rotation update);
- per-particle finite rotation (Euler–Rodrigues in 3D; 2D closed form):
    τ* = R τ Rᵀ with rotation angle θ = ω·dt.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from justrelax_tpu.ops.stencil import av_a

Array = Any

__all__ = [
    "rotate_stress_grid_2d",
    "rotate_stress_particles_2d",
    "rotate_stress_particles_3d",
    "compute_vorticity_center",
]


def compute_vorticity_center(Vx, Vy, inv_dx, inv_dy):
    """ω_xy = ½(∂Vy/∂x − ∂Vx/∂y) averaged to cell centers."""
    w_v = 0.5 * (
        (Vy[1:, :] - Vy[:-1, :]) * inv_dx - (Vx[:, 1:] - Vx[:, :-1]) * inv_dy
    )
    return av_a(w_v)


def rotate_stress_grid_2d(txx, tyy, txy_c, omega_c, dt):
    """Jaumann co-rotation of the center stress tensor by ω·dt."""
    # dτ/dt = τ·W − W·τ with W = [[0, −ω], [ω, 0]]
    dxx = -2.0 * omega_c * txy_c
    dyy = 2.0 * omega_c * txy_c
    dxy = omega_c * (txx - tyy)
    return txx + dt * dxx, tyy + dt * dyy, txy_c + dt * dxy


def rotate_stress_particles_2d(p_txx, p_tyy, p_txy, omega_p, dt):
    """Finite rotation of per-particle stress by θ = ω·dt (reference
    rotate_stress_particles! finite-rotation-matrix variant)."""
    theta = omega_p * dt
    c, s = jnp.cos(theta), jnp.sin(theta)
    # R τ Rᵀ for R = [[c, −s], [s, c]]
    xx = c * c * p_txx - 2 * c * s * p_txy + s * s * p_tyy
    yy = s * s * p_txx + 2 * c * s * p_txy + c * c * p_tyy
    xy = c * s * (p_txx - p_tyy) + (c * c - s * s) * p_txy
    return xx, yy, xy


def rotate_stress_particles_3d(
    p_txx, p_tyy, p_tzz, p_tyz, p_txz, p_txy,
    omega_yz, omega_xz, omega_xy, dt,
):
    """Euler–Rodrigues finite rotation of per-particle 3D stress
    (reference rotate_stress_particles_GeoParams! 3D variant,
    stress_rotation_particles.jl:114-141 → GeoParams rotate_elastic_stress3D).

    ``omega_ab = ½(∂V_a/∂x_b − ∂V_b/∂x_a)`` are the spin-tensor components
    (same convention as :func:`compute_vorticity_center` / the 2D variant:
    a pure ``omega_xy`` spin reduces exactly to
    :func:`rotate_stress_particles_2d`). The rotation vector is
    ``w = (ω_yz, −ω_xz, ω_xy)``; angle θ = |w|·dt; R from the
    Euler–Rodrigues formula; τ' = R τ Rᵀ, fully vectorized over the
    trailing particle axes.
    """
    wx, wy, wz = omega_yz, -omega_xz, omega_xy
    wmag = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    theta = wmag * dt
    safe = jnp.where(wmag > 0.0, wmag, 1.0)
    nx_, ny_, nz_ = wx / safe, wy / safe, wz / safe
    c, s = jnp.cos(theta), jnp.sin(theta)
    one_c = 1.0 - c

    # R = I + sinθ [n]× + (1−cosθ)[n]×²  (batched 3×3, particle axes last)
    R = jnp.stack(
        [
            jnp.stack([c + nx_ * nx_ * one_c, nx_ * ny_ * one_c - nz_ * s, nx_ * nz_ * one_c + ny_ * s]),
            jnp.stack([ny_ * nx_ * one_c + nz_ * s, c + ny_ * ny_ * one_c, ny_ * nz_ * one_c - nx_ * s]),
            jnp.stack([nz_ * nx_ * one_c - ny_ * s, nz_ * ny_ * one_c + nx_ * s, c + nz_ * nz_ * one_c]),
        ]
    )  # (3, 3, ...)
    tau = jnp.stack(
        [
            jnp.stack([p_txx, p_txy, p_txz]),
            jnp.stack([p_txy, p_tyy, p_tyz]),
            jnp.stack([p_txz, p_tyz, p_tzz]),
        ]
    )  # (3, 3, ...)
    # τ' = R τ Rᵀ with matrix axes in front, as elementwise products summed
    # over the 3×3 axes: no dot is emitted, so a GPU never runs it in TF32
    A = jnp.sum(R[:, :, None] * tau[None, :, :], axis=1)  # (R τ)_il
    taur = jnp.sum(A[:, None, :] * R[None, :, :], axis=2)  # (R τ Rᵀ)_ij
    return (
        taur[0, 0], taur[1, 1], taur[2, 2],
        taur[1, 2], taur[0, 2], taur[0, 1],
    )
