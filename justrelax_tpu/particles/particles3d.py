"""3D particle-in-cell transport (the JustPIC._3D surface used by the
reference's 3D miniapps: init_particles, advection!(RK2), move_particles!,
particle2grid!/grid2particle!, centroid transfers, phase ratios).

Same design as the 2D module (fixed per-cell slots + active masks,
vectorized trilinear transfers); shapes are (nx, ny, nz, max_xcell).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.pytree import dataclass, field

Array = Any

__all__ = [
    "Particles3D",
    "init_particles_3d",
    "advect_rk2_3d",
    "move_particles_3d",
    "particle2grid_3d",
    "grid2particle_3d",
    "particle2centroid_3d",
    "centroid2particle_3d",
    "phase_ratios_from_particles_3d",
    "inject_particles_3d",
]


@dataclass
class Particles3D:
    px: Array  # (nx, ny, nz, max_xcell)
    py: Array
    pz: Array
    active: Array
    min_xcell: int = field(static=True, default=0)
    nxcell: int = field(static=True, default=0)

    @property
    def max_xcell(self) -> int:
        return self.px.shape[-1]

    def count(self):
        return jnp.sum(self.active, axis=-1)


def init_particles_3d(geometry, nxcell: int, max_xcell: int, min_xcell: int,
                      seed: int = 0) -> Particles3D:
    """Stratified-random particles, ``nxcell`` per cell."""
    nx, ny, nz = geometry.ni
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    rng = np.random.default_rng(seed)
    m = int(math.ceil(nxcell ** (1.0 / 3.0)))
    sub = np.stack(
        np.meshgrid(*(((np.arange(m) + 0.5) / m,) * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)[:nxcell]
    jitter = (rng.random((nx, ny, nz, nxcell, 3)) - 0.5) / m * 0.9
    pos = sub[None, None, None] + jitter
    I = np.arange(nx)[:, None, None, None]
    J = np.arange(ny)[None, :, None, None]
    K = np.arange(nz)[None, None, :, None]
    X = ox + (I + pos[..., 0]) * dx
    Y = oy + (J + pos[..., 1]) * dy
    Z = oz + (K + pos[..., 2]) * dz
    shape = (nx, ny, nz, max_xcell)
    px, py, pz = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    px[..., :nxcell], py[..., :nxcell], pz[..., :nxcell] = X, Y, Z
    active = np.zeros(shape, dtype=bool)
    active[..., :nxcell] = True
    return Particles3D(
        px=jnp.asarray(px), py=jnp.asarray(py), pz=jnp.asarray(pz),
        active=jnp.asarray(active), min_xcell=min_xcell, nxcell=nxcell,
    )


def _trilinear(F, x0, y0, z0, dx, dy, dz, X, Y, Z):
    nx, ny, nz = F.shape
    fx = (X - x0) / dx
    fy = (Y - y0) / dy
    fz = (Z - z0) / dz
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    iz = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)
    tx = jnp.clip(fx - ix, 0.0, 1.0)
    ty = jnp.clip(fy - iy, 0.0, 1.0)
    tz = jnp.clip(fz - iz, 0.0, 1.0)
    out = 0.0
    for di, wx in ((0, 1 - tx), (1, tx)):
        for dj, wy in ((0, 1 - ty), (1, ty)):
            for dk, wz in ((0, 1 - tz), (1, tz)):
                out = out + F[ix + di, iy + dj, iz + dk] * wx * wy * wz
    return out


def particle_velocity_3d(Vx, Vy, Vz, geometry, X, Y, Z):
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    vx = _trilinear(Vx, ox, oy - dy / 2, oz - dz / 2, dx, dy, dz, X, Y, Z)
    vy = _trilinear(Vy, ox - dx / 2, oy, oz - dz / 2, dx, dy, dz, X, Y, Z)
    vz = _trilinear(Vz, ox - dx / 2, oy - dy / 2, oz, dx, dy, dz, X, Y, Z)
    return vx, vy, vz


def advect_rk2_3d(particles: Particles3D, V, geometry, dt) -> Particles3D:
    Vx, Vy, Vz = V
    X, Y, Z = particles.px, particles.py, particles.pz
    v1 = particle_velocity_3d(Vx, Vy, Vz, geometry, X, Y, Z)
    Xh = X + 0.5 * dt * v1[0]
    Yh = Y + 0.5 * dt * v1[1]
    Zh = Z + 0.5 * dt * v1[2]
    v2 = particle_velocity_3d(Vx, Vy, Vz, geometry, Xh, Yh, Zh)
    Xn, Yn, Zn = X + dt * v2[0], Y + dt * v2[1], Z + dt * v2[2]
    o = geometry.origin
    li = geometry.li
    eps = 1e-12 * max(li)
    Xn = jnp.clip(Xn, o[0] + eps, o[0] + li[0] - eps)
    Yn = jnp.clip(Yn, o[1] + eps, o[1] + li[1] - eps)
    Zn = jnp.clip(Zn, o[2] + eps, o[2] + li[2] - eps)
    a = particles.active
    return particles.replace(
        px=jnp.where(a, Xn, X), py=jnp.where(a, Yn, Y), pz=jnp.where(a, Zn, Z)
    )


def _neighborhood27(A, fill):
    """Stack the 3×3×3 neighborhood along the slot axis → (..., 27·m)."""
    parts = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                S = jnp.roll(A, shift=(-di, -dj, -dk), axis=(0, 1, 2))
                valid = jnp.ones(A.shape, dtype=bool)
                for ax, d in ((0, di), (1, dj), (2, dk)):
                    if d == 1:
                        idx = [slice(None)] * A.ndim
                        idx[ax] = -1
                        valid = valid.at[tuple(idx)].set(False)
                    elif d == -1:
                        idx = [slice(None)] * A.ndim
                        idx[ax] = 0
                        valid = valid.at[tuple(idx)].set(False)
                parts.append(jnp.where(valid, S, fill))
    return jnp.concatenate(parts, axis=-1)


def move_particles_3d(
    particles: Particles3D, geometry, fields: Dict[str, Array]
) -> Tuple[Particles3D, Dict[str, Array]]:
    """Re-slot particles into their current cells (CFL ≤ 1 cell/step)."""
    nx, ny, nz = particles.px.shape[:3]
    mx = particles.max_xcell
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin

    cx = _neighborhood27(particles.px, 0.0)
    cy = _neighborhood27(particles.py, 0.0)
    cz = _neighborhood27(particles.pz, 0.0)
    ca = _neighborhood27(particles.active, False)
    cf = {k: _neighborhood27(v, 0.0) for k, v in fields.items()}

    ci = jnp.clip(jnp.floor((cx - ox) / dx).astype(jnp.int32), 0, nx - 1)
    cj = jnp.clip(jnp.floor((cy - oy) / dy).astype(jnp.int32), 0, ny - 1)
    ck = jnp.clip(jnp.floor((cz - oz) / dz).astype(jnp.int32), 0, nz - 1)
    II = jnp.arange(nx)[:, None, None, None]
    JJ = jnp.arange(ny)[None, :, None, None]
    KK = jnp.arange(nz)[None, None, :, None]
    belongs = ca & (ci == II) & (cj == JJ) & (ck == KK)

    order = jnp.argsort(~belongs, axis=-1, stable=True)[..., :mx]
    take = lambda A: jnp.take_along_axis(A, order, axis=-1)
    new = particles.replace(
        px=take(cx), py=take(cy), pz=take(cz), active=take(belongs)
    )
    return new, {k: take(v) for k, v in cf.items()}


def _corner_weights_3d(particles, geometry):
    """Trilinear weights of each particle w.r.t. its cell's 8 vertices."""
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    fx = (particles.px - ox) / dx
    fy = (particles.py - oy) / dy
    fz = (particles.pz - oz) / dz
    i = jnp.floor(fx).astype(jnp.int32)
    j = jnp.floor(fy).astype(jnp.int32)
    k = jnp.floor(fz).astype(jnp.int32)
    return (fx - i, fy - j, fz - k)


def particle2grid_3d(field: Array, particles: Particles3D, geometry) -> Array:
    """Particle field → vertices (nx+1, ny+1, nz+1), inverse-trilinear
    Shepard weighting (JustPIC particle2grid!)."""
    nx, ny, nz = particles.px.shape[:3]
    tx, ty, tz = _corner_weights_3d(particles, geometry)
    a = particles.active
    num = jnp.zeros((nx + 1, ny + 1, nz + 1))
    den = jnp.zeros((nx + 1, ny + 1, nz + 1))
    I = jnp.arange(nx)[:, None, None, None]
    J = jnp.arange(ny)[None, :, None, None]
    K = jnp.arange(nz)[None, None, :, None]
    shape = particles.px.shape
    for di, wx in ((0, 1 - tx), (1, tx)):
        for dj, wy in ((0, 1 - ty), (1, ty)):
            for dk, wz in ((0, 1 - tz), (1, tz)):
                w = jnp.where(a, wx * wy * wz, 0.0)
                Ib = jnp.broadcast_to(I + di, shape)
                Jb = jnp.broadcast_to(J + dj, shape)
                Kb = jnp.broadcast_to(K + dk, shape)
                num = num.at[Ib, Jb, Kb].add(w * field)
                den = den.at[Ib, Jb, Kb].add(w)
    return num / jnp.where(den == 0, 1.0, den)


def grid2particle_3d(vertex_field: Array, particles: Particles3D, geometry) -> Array:
    ox, oy, oz = geometry.origin
    dx, dy, dz = geometry.di
    return _trilinear(
        vertex_field, ox, oy, oz, dx, dy, dz,
        particles.px, particles.py, particles.pz,
    )


def particle2centroid_3d(field: Array, particles: Particles3D, geometry) -> Array:
    """Particle field → cell centers, distance-weighted."""
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    nx, ny, nz = particles.px.shape[:3]
    xc = ox + (jnp.arange(nx)[:, None, None, None] + 0.5) * dx
    yc = oy + (jnp.arange(ny)[None, :, None, None] + 0.5) * dy
    zc = oz + (jnp.arange(nz)[None, None, :, None] + 0.5) * dz
    w = jnp.where(
        particles.active,
        1.0 / jnp.maximum(
            jnp.abs(particles.px - xc) / dx
            + jnp.abs(particles.py - yc) / dy
            + jnp.abs(particles.pz - zc) / dz,
            1e-10,
        ),
        0.0,
    )
    den = jnp.sum(w, axis=-1)
    return jnp.sum(w * field, axis=-1) / jnp.where(den == 0, 1.0, den)


def centroid2particle_3d(center_field: Array, particles: Particles3D, geometry) -> Array:
    ox, oy, oz = geometry.origin
    dx, dy, dz = geometry.di
    return _trilinear(
        center_field, ox + dx / 2, oy + dy / 2, oz + dz / 2, dx, dy, dz,
        particles.px, particles.py, particles.pz,
    )


def phase_ratios_from_particles_3d(
    particles: Particles3D, phase: Array, nphase: int, geometry
) -> Tuple[Array, Array]:
    """(center ratios (nx,ny,nz,nphase), vertex ratios (+1 each, nphase))."""
    nx, ny, nz = particles.px.shape[:3]
    a = particles.active
    cr = []
    for p in range(nphase):
        w = jnp.where(a & (jnp.round(phase) == p), 1.0, 0.0)
        cr.append(jnp.sum(w, axis=-1))
    center = jnp.stack(cr, axis=-1)
    s = jnp.sum(center, axis=-1, keepdims=True)
    center = center / jnp.where(s == 0, 1.0, s)
    vert = []
    for p in range(nphase):
        vert.append(
            particle2grid_3d(
                jnp.where(jnp.round(phase) == p, 1.0, 0.0), particles, geometry
            )
        )
    vertex = jnp.stack(vert, axis=-1)
    sv = jnp.sum(vertex, axis=-1, keepdims=True)
    vertex = vertex / jnp.where(sv == 0, 1.0, sv)
    return center, vertex


def inject_particles_3d(
    particles: Particles3D,
    geometry,
    fields_from_centers: Dict[str, Array],
    phases: Optional[int] = None,
    phase_field: Optional[str] = "phase",
    fields: Optional[Dict[str, Array]] = None,
) -> Tuple[Particles3D, Dict[str, Array]]:
    """Refill cells below ``min_xcell`` (JustPIC inject_particles_phase!,
    3D): new particles at sub-cell lattice positions, scalars interpolated
    from center fields, phase = dominant among the cell's survivors."""
    fields = fields or {}
    nx, ny, nz = particles.px.shape[:3]
    mx = particles.max_xcell
    dx, dy, dz = geometry.di
    ox, oy, oz = geometry.origin
    count = particles.count()
    needs = count < particles.min_xcell

    m = int(math.ceil(mx ** (1.0 / 3.0)))
    sub = np.stack(
        np.meshgrid(*(((np.arange(m) + 0.5) / m,) * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)[:mx]
    s = jnp.asarray(sub)[None, None, None]
    newx = ox + (jnp.arange(nx)[:, None, None, None] + s[..., 0]) * dx
    newy = oy + (jnp.arange(ny)[None, :, None, None] + s[..., 1]) * dy
    newz = oz + (jnp.arange(nz)[None, None, :, None] + s[..., 2]) * dz

    slot_rank = jnp.cumsum(~particles.active, axis=-1)
    to_fill = (
        needs[..., None]
        & ~particles.active
        & (slot_rank <= (particles.nxcell - count)[..., None])
    )
    px = jnp.where(to_fill, newx, particles.px)
    py = jnp.where(to_fill, newy, particles.py)
    pz = jnp.where(to_fill, newz, particles.pz)
    active = particles.active | to_fill
    filled = particles.replace(px=px, py=py, pz=pz, active=active)

    new_fields = {}
    for k, v in fields.items():
        if k in fields_from_centers:
            interp = centroid2particle_3d(fields_from_centers[k], filled, geometry)
            new_fields[k] = jnp.where(to_fill, interp, v)
        elif k == phase_field:
            w = jnp.where(particles.active, 1.0, 0.0)
            nphase = phases if phases is not None else int(jnp.max(v).item()) + 1
            counts = jnp.stack(
                [jnp.sum(w * (jnp.round(v) == q), axis=-1) for q in range(nphase)],
                axis=-1,
            )
            dominant = jnp.argmax(counts, axis=-1).astype(v.dtype)
            new_fields[k] = jnp.where(to_fill, dominant[..., None], v)
        else:
            new_fields[k] = v
    return filled, new_fields
