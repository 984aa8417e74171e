"""Particle-in-cell material transport (JustPIC equivalent, SURVEY.md §2.4).

JAX-native design: particles live in *fixed per-cell slots* — every array has
shape ``(nx, ny, max_xcell)`` with an ``active`` mask — which is exactly the
reference's CellArray layout (`@index particles.index[ip, i, j]`) made
explicit. All operations are static-shape and vectorized:

- bilinear interpolation of the staggered (ghosted) velocity grids at
  particle positions; RK2 (midpoint) advection;
- ``move_particles``: slot compaction over the 3×3 neighborhood via a single
  argsort per cell (particles never travel more than one cell per step under
  CFL ≤ 1);
- particle↔grid transfers: vertex (`particle2grid`/`grid2particle`) and
  centroid variants, inverse-distance-weighted like JustPIC's bilinear
  kernels;
- ``inject_particles``: refill under-populated cells from grid-interpolated
  values;
- phase ratios at centers and vertices from particle phases;
- subgrid temperature diffusion (reference src/particles/subgrid_diffusion.jl).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.pytree import dataclass, field

Array = Any

__all__ = [
    "Particles",
    "init_particles",
    "particle_velocity",
    "advect_rk2",
    "move_particles",
    "inject_particles",
    "particle2grid",
    "grid2particle",
    "particle2centroid",
    "centroid2particle",
    "phase_ratios_from_particles",
    "subgrid_diffusion",
]


@dataclass
class Particles:
    px: Array  # (nx, ny, max_xcell) absolute x
    py: Array
    active: Array  # bool mask
    min_xcell: int = field(static=True, default=0)
    nxcell: int = field(static=True, default=0)

    @property
    def max_xcell(self) -> int:
        return self.px.shape[-1]

    def count(self):
        return jnp.sum(self.active, axis=-1)


def init_particles(geometry, nxcell: int, max_xcell: int, min_xcell: int, seed: int = 0):
    """Stratified-random particles: ``nxcell`` per cell, ``max_xcell`` slots."""
    nx, ny = geometry.ni
    dx, dy = geometry.di
    ox, oy = geometry.origin
    rng = np.random.default_rng(seed)
    m = int(math.ceil(math.sqrt(nxcell)))
    # stratified sub-cell positions for the first nxcell slots
    sub = np.stack(
        np.meshgrid((np.arange(m) + 0.5) / m, (np.arange(m) + 0.5) / m, indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)[:nxcell]
    jitter = (rng.random((nx, ny, nxcell, 2)) - 0.5) / m * 0.9
    pos = sub[None, None, :, :] + jitter
    X = ox + (np.arange(nx)[:, None, None] + pos[..., 0]) * dx
    Y = oy + (np.arange(ny)[None, :, None] + pos[..., 1]) * dy
    px = np.zeros((nx, ny, max_xcell))
    py = np.zeros((nx, ny, max_xcell))
    px[..., :nxcell] = X
    py[..., :nxcell] = Y
    active = np.zeros((nx, ny, max_xcell), dtype=bool)
    active[..., :nxcell] = True
    return Particles(
        px=jnp.asarray(px),
        py=jnp.asarray(py),
        active=jnp.asarray(active),
        min_xcell=min_xcell,
        nxcell=nxcell,
    )


# --- interpolation ----------------------------------------------------------
def _bilinear(F, x0, y0, dx, dy, X, Y):
    """Bilinear sample of grid F (node coords x0+i·dx, y0+j·dy) at (X, Y)."""
    nx, ny = F.shape
    fx = (X - x0) / dx
    fy = (Y - y0) / dy
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    tx = jnp.clip(fx - ix, 0.0, 1.0)
    ty = jnp.clip(fy - iy, 0.0, 1.0)
    f00 = F[ix, iy]
    f10 = F[ix + 1, iy]
    f01 = F[ix, iy + 1]
    f11 = F[ix + 1, iy + 1]
    return (
        f00 * (1 - tx) * (1 - ty)
        + f10 * tx * (1 - ty)
        + f01 * (1 - tx) * ty
        + f11 * tx * ty
    )


def particle_velocity(Vx, Vy, geometry, X, Y):
    """Velocity at particle positions from the ghosted staggered grids."""
    dx, dy = geometry.di
    ox, oy = geometry.origin
    vx = _bilinear(Vx, ox, oy - dy / 2, dx, dy, X, Y)
    vy = _bilinear(Vy, ox - dx / 2, oy, dx, dy, X, Y)
    return vx, vy


def advect_rk2(particles: Particles, V: Tuple[Array, Array], geometry, dt):
    """Midpoint RK2 advection (JustPIC ``advection!(..., RungeKutta2(), ...)``)."""
    Vx, Vy = V
    X, Y = particles.px, particles.py
    vx1, vy1 = particle_velocity(Vx, Vy, geometry, X, Y)
    Xh = X + 0.5 * dt * vx1
    Yh = Y + 0.5 * dt * vy1
    vx2, vy2 = particle_velocity(Vx, Vy, geometry, Xh, Yh)
    Xn = X + dt * vx2
    Yn = Y + dt * vy2
    # clamp into the domain
    ox, oy = geometry.origin
    lx, ly = geometry.li
    eps = 1e-12 * max(lx, ly)
    Xn = jnp.clip(Xn, ox + eps, ox + lx - eps)
    Yn = jnp.clip(Yn, oy + eps, oy + ly - eps)
    Xn = jnp.where(particles.active, Xn, X)
    Yn = jnp.where(particles.active, Yn, Y)
    return particles.replace(px=Xn, py=Yn)


# --- cell reassignment ------------------------------------------------------
def _neighborhood(A, fill):
    """Stack the 3×3 neighborhood along the slot axis → (nx, ny, 9·mx)."""
    parts = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            # S[i] = A[i + di] (neighbor at offset +di), wraps masked below
            S = jnp.roll(A, shift=(-di, -dj), axis=(0, 1))
            valid = jnp.ones(A.shape, dtype=bool)
            if di == 1:
                valid = valid.at[-1, :].set(False)  # S[-1] wrapped from A[0]
            elif di == -1:
                valid = valid.at[0, :].set(False)  # S[0] wrapped from A[-1]
            if dj == 1:
                valid = valid.at[:, -1].set(False)
            elif dj == -1:
                valid = valid.at[:, 0].set(False)
            parts.append(jnp.where(valid, S, fill))
    return jnp.concatenate(parts, axis=-1)


def move_particles(
    particles: Particles, geometry, fields: Dict[str, Array]
) -> Tuple[Particles, Dict[str, Array]]:
    """Re-slot particles into their current cells (JustPIC move_particles!).

    Assumes CFL-limited motion (≤ 1 cell per step): candidates come from the
    3×3 neighborhood; each cell keeps up to ``max_xcell`` by slot compaction.
    """
    nx, ny = particles.px.shape[:2]
    mx = particles.max_xcell
    dx, dy = geometry.di
    ox, oy = geometry.origin

    cand_x = _neighborhood(particles.px, 0.0)
    cand_y = _neighborhood(particles.py, 0.0)
    cand_a = _neighborhood(particles.active, False)
    cand_fields = {k: _neighborhood(v, 0.0) for k, v in fields.items()}

    ci = jnp.clip(jnp.floor((cand_x - ox) / dx).astype(jnp.int32), 0, nx - 1)
    cj = jnp.clip(jnp.floor((cand_y - oy) / dy).astype(jnp.int32), 0, ny - 1)
    II = jnp.arange(nx)[:, None, None]
    JJ = jnp.arange(ny)[None, :, None]
    belongs = cand_a & (ci == II) & (cj == JJ)

    # compact: active-belonging first, take max_xcell slots
    order = jnp.argsort(~belongs, axis=-1, stable=True)[..., :mx]
    take = lambda A: jnp.take_along_axis(A, order, axis=-1)
    new_active = take(belongs)
    new = particles.replace(
        px=take(cand_x), py=take(cand_y), active=new_active
    )
    new_fields = {k: take(v) for k, v in cand_fields.items()}
    return new, new_fields


# --- particle ↔ grid transfers ---------------------------------------------
def _corner_weights(particles, geometry, xnode, ynode):
    """Inverse-bilinear weight of each particle w.r.t. a node position grid."""
    dx, dy = geometry.di
    wx = 1.0 - jnp.abs(particles.px - xnode) / dx
    wy = 1.0 - jnp.abs(particles.py - ynode) / dy
    w = jnp.clip(wx, 0.0, 1.0) * jnp.clip(wy, 0.0, 1.0)
    return jnp.where(particles.active, w, 0.0)


def particle2grid(field: Array, particles: Particles, geometry) -> Array:
    """Particle field → vertices (nx+1, ny+1), bilinear-weighted average."""
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin
    num = jnp.zeros((nx + 2, ny + 2), field.dtype)
    den = jnp.zeros((nx + 2, ny + 2), field.dtype)
    # each particle contributes to the 4 vertices of its cell
    ci = jnp.clip(jnp.floor((particles.px - ox) / dx).astype(jnp.int32), 0, nx - 1)
    cj = jnp.clip(jnp.floor((particles.py - oy) / dy).astype(jnp.int32), 0, ny - 1)
    for di in (0, 1):
        for dj in (0, 1):
            vx_pos = ox + (ci + di) * dx
            vy_pos = oy + (cj + dj) * dy
            w = _corner_weights(particles, geometry, vx_pos, vy_pos)
            num = num.at[ci + di, cj + dj].add(w * field)
            den = den.at[ci + di, cj + dj].add(w)
    out = num[:-1, :-1] / jnp.where(den[:-1, :-1] == 0, 1.0, den[:-1, :-1])
    return out[: nx + 1, : ny + 1]


def grid2particle(vertex_field: Array, particles: Particles, geometry) -> Array:
    """Vertex field (nx+1, ny+1) → particle positions (bilinear)."""
    ox, oy = geometry.origin
    dx, dy = geometry.di
    return _bilinear(vertex_field, ox, oy, dx, dy, particles.px, particles.py)


def particle2centroid(field: Array, particles: Particles, geometry) -> Array:
    """Particle field → cell centers (nx, ny), weighted by distance to the
    centroid (JustPIC particle2centroid!)."""
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin
    xc = ox + (jnp.arange(nx)[:, None, None] + 0.5) * dx
    yc = oy + (jnp.arange(ny)[None, :, None] + 0.5) * dy
    w = _corner_weights(particles, geometry, xc, yc)
    num = jnp.sum(w * field, axis=-1)
    den = jnp.sum(w, axis=-1)
    return num / jnp.where(den == 0, 1.0, den)


def centroid2particle(center_field: Array, particles: Particles, geometry) -> Array:
    """Center field → particles, bilinear on the center lattice.

    A plain (nx, ny) field is edge-clamped: particles between the outermost
    centroid and the wall see the centroid value. A GHOSTED field
    (nx+2, ny+2) interpolates on the ghost-center lattice instead — the
    ghost values encode the boundary conditions (e.g. 2·T_bc − T_in), so
    near-wall particles interpolate *through* the physical boundary value.
    Pass the ghosted array wherever the field has meaningful BCs (the clamp
    visibly corrupts the wall gradient of a linear geotherm: Nu in the
    Blankenbach PIC loop reads 1.14 instead of 1.00 with the clamped form).
    """
    ox, oy = geometry.origin
    dx, dy = geometry.di
    nx, ny = particles.px.shape[:2]
    if center_field.shape == (nx + 2, ny + 2):
        return _bilinear(
            center_field, ox - dx / 2, oy - dy / 2, dx, dy,
            particles.px, particles.py,
        )
    return _bilinear(
        center_field, ox + dx / 2, oy + dy / 2, dx, dy, particles.px, particles.py
    )


# --- injection --------------------------------------------------------------
def inject_particles(
    particles: Particles,
    geometry,
    fields_from_centers: Dict[str, Array],
    phases: Optional[Array] = None,
    phase_field: Optional[str] = "phase",
    fields: Optional[Dict[str, Array]] = None,
) -> Tuple[Particles, Dict[str, Array]]:
    """Refill cells that dropped below ``min_xcell`` active particles
    (JustPIC inject_particles_phase!).

    New particles appear at sub-cell lattice positions; scalar fields are
    interpolated from the given center arrays; the phase (if tracked in
    ``fields``) takes the cell's dominant phase among surviving particles.
    """
    fields = fields or {}
    nx, ny = particles.px.shape[:2]
    mx = particles.max_xcell
    dx, dy = geometry.di
    ox, oy = geometry.origin
    count = particles.count()
    needs = count < particles.min_xcell

    m = int(math.ceil(math.sqrt(mx)))
    sub = np.stack(
        np.meshgrid((np.arange(m) + 0.5) / m, (np.arange(m) + 0.5) / m, indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)[:mx]
    subx = jnp.asarray(sub[:, 0])[None, None, :]
    suby = jnp.asarray(sub[:, 1])[None, None, :]
    newx = ox + (jnp.arange(nx)[:, None, None] + subx) * dx
    newy = oy + (jnp.arange(ny)[None, :, None] + suby) * dy

    # activate inactive slots in needy cells up to nxcell
    slot_rank = jnp.cumsum(~particles.active, axis=-1)
    to_fill = (
        needs[..., None]
        & ~particles.active
        & (slot_rank <= (particles.nxcell - count)[..., None])
    )
    px = jnp.where(to_fill, newx, particles.px)
    py = jnp.where(to_fill, newy, particles.py)
    active = particles.active | to_fill

    new_fields = {}
    for k, v in fields.items():
        if k in fields_from_centers:
            interp = centroid2particle(
                fields_from_centers[k],
                particles.replace(px=px, py=py, active=active),
                geometry,
            )
            new_fields[k] = jnp.where(to_fill, interp, v)
        elif k == phase_field:
            # dominant phase among surviving particles of the cell
            # (JustPIC inject_particles_phase! seeds from nearby particle
            # phases); a cell with NO survivors — e.g. fully emptied by the
            # marker-chain topography correction — falls back to the given
            # ``phases`` cell field instead of silently taking phase 0
            w = jnp.where(particles.active, 1.0, 0.0)
            if isinstance(phases, int):
                nphase = phases
            else:
                ref = v if phases is None else phases
                nphase = int(jnp.max(ref).item()) + 1
            counts = jnp.stack(
                [jnp.sum(w * (v == p), axis=-1) for p in range(nphase)], axis=-1
            )
            dominant = jnp.argmax(counts, axis=-1).astype(v.dtype)
            if phases is not None and not isinstance(phases, int):
                dominant = jnp.where(
                    jnp.sum(w, axis=-1) > 0, dominant, phases.astype(v.dtype)
                )
            new_fields[k] = jnp.where(to_fill, dominant[..., None], v)
        else:
            new_fields[k] = v
    return particles.replace(px=px, py=py, active=active), new_fields


# --- phase ratios -----------------------------------------------------------
def phase_ratios_from_particles(
    particles: Particles, phase: Array, nphase: int, geometry
) -> Tuple[Array, Array]:
    """(center_ratios (nx,ny,nphase), vertex_ratios (nx+1,ny+1,nphase)) from
    per-particle integer phases, bilinear-weighted (reference
    update_phase_ratios!)."""
    nx, ny = particles.px.shape[:2]
    dx, dy = geometry.di
    ox, oy = geometry.origin

    # centers
    xc = ox + (jnp.arange(nx)[:, None, None] + 0.5) * dx
    yc = oy + (jnp.arange(ny)[None, :, None] + 0.5) * dy
    wc = _corner_weights(particles, geometry, xc, yc)
    num_c = jnp.stack(
        [jnp.sum(wc * (phase == p), axis=-1) for p in range(nphase)], axis=-1
    )
    den_c = jnp.sum(num_c, axis=-1, keepdims=True)
    center = num_c / jnp.where(den_c == 0, 1.0, den_c)

    # vertices: accumulate from the 4 adjacent cells
    ci = jnp.clip(jnp.floor((particles.px - ox) / dx).astype(jnp.int32), 0, nx - 1)
    cj = jnp.clip(jnp.floor((particles.py - oy) / dy).astype(jnp.int32), 0, ny - 1)
    num_v = jnp.zeros((nx + 2, ny + 2, nphase))
    for di in (0, 1):
        for dj in (0, 1):
            vx_pos = ox + (ci + di) * dx
            vy_pos = oy + (cj + dj) * dy
            w = _corner_weights(particles, geometry, vx_pos, vy_pos)
            for p in range(nphase):
                num_v = num_v.at[ci + di, cj + dj, p].add(w * (phase == p))
    num_v = num_v[: nx + 1, : ny + 1]
    den_v = jnp.sum(num_v, axis=-1, keepdims=True)
    vertex = num_v / jnp.where(den_v == 0, 1.0, den_v)
    return center, vertex


# --- subgrid diffusion ------------------------------------------------------
def subgrid_characteristic_time(material, T, P, phase_ratios, di):
    """dt₀ = ρCp / (K·(2/dx² + 2/dy²)) per cell (reference
    src/particles/subgrid_diffusion.jl)."""
    from justrelax_tpu.rheology.materials import compute_conductivity, compute_rhoCp

    rhoCp = compute_rhoCp(material, T=T, P=P, phase_ratios=phase_ratios)
    K = compute_conductivity(material, T=T, P=P, phase_ratios=phase_ratios)
    return rhoCp / (K * (2.0 / di[0] ** 2 + 2.0 / di[1] ** 2))


def subgrid_diffusion(
    pT: Array, T_grid: Array, dT_grid: Array, dt0_grid: Array,
    particles: Particles, geometry, dt, d=1.0
):
    """Gerya-scheme subgrid diffusion of the particle temperature (JustPIC
    ``subgrid_diffusion_centroid!``; reference call site
    test_Blankenbach.jl:223-226).

    The particle temperature relaxes toward the PRE-diffusion grid field on
    the subgrid characteristic time, and the grid increment that the subgrid
    relaxation did not account for is added back:

      ΔT_sub^p  = (T_old@p − pT)·(1 − exp(−d·dt/dt₀@p))
      ΔT_rem    = ΔT_grid − P2G(ΔT_sub^p)
      pT        ← pT + ΔT_sub^p + ΔT_rem@p

    ``T_grid`` is the post-diffusion grid temperature and ``dT_grid`` the
    diffusion increment (thermal.dT = T − Told). Pass them GHOSTED
    ((nx+2, ny+2), as ``thermal.T``/``thermal.dT`` are stored) so near-wall
    particles interpolate through the boundary values; plain (nx, ny)
    center arrays are accepted with edge-clamped interpolation.
    """
    nx, ny = particles.px.shape[:2]
    ghosted = T_grid.shape == (nx + 2, ny + 2)
    T_old_p = centroid2particle(T_grid - dT_grid, particles, geometry)
    dt0_at_p = centroid2particle(dt0_grid, particles, geometry)
    fac = jnp.exp(-d * dt / jnp.maximum(dt0_at_p, 1e-30))
    dT_sub_p = jnp.where(particles.active, (T_old_p - pT) * (1.0 - fac), 0.0)
    dT_sub_grid = particle2centroid(dT_sub_p, particles, geometry)
    if ghosted:
        dT_rem = dT_grid.at[1:-1, 1:-1].add(-dT_sub_grid)
    else:
        dT_rem = dT_grid - dT_sub_grid
    dT_rem_p = centroid2particle(dT_rem, particles, geometry)
    return jnp.where(particles.active, pT + dT_sub_p + dT_rem_p, pT)
