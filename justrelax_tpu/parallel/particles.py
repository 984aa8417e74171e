"""Distributed (multi-device) particle transport, 2D.

The reference's particles live in JustPIC CellArrays and migrate between
MPI ranks inside ``move_particles!`` (SURVEY §2.4). The JAX-native design:

- particle slot arrays are *blocked-local* like the grid fields
  (``(px·nxl, py·nyl, max_xcell)`` containers), with positions stored
  RELATIVE TO THE LOCAL BLOCK ORIGIN so every device shares one static
  local geometry;
- advection interpolates ghost-extended local velocities (``halo.extend``
  of the face axes), so RK2 midpoints near block edges see the neighbor's
  values exactly as a serial solve would;
- migration reuses the serial compaction: each particle field is
  ghost-extended by one CELL of neighbor slots (``lax.ppermute`` slabs,
  positions shifted into the local frame, physical-boundary ghosts
  deactivated), the serial ``move_particles`` runs on the extended block,
  and the interior is kept. Emigrants land in the neighbor's interior and
  in our ghosts (dropped) — no separate send/recv bookkeeping.

CFL ≤ 1 cell per step is assumed, like the serial ``move_particles``.
Loop timesteps with ``lax.fori_loop`` (one compiled step body) — unrolled
Python loops re-trace the slot-compaction argsort per step and compile
very slowly.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.parallel import halo
from justrelax_tpu.particles.particles import Particles, _bilinear, move_particles

Array = Any

__all__ = [
    "block_particles",
    "unblock_particles",
    "local_particle_geometry",
    "advect_move_local",
]


def block_particles(particles: Particles, geometry, decomp):
    """Host-side: make positions block-relative (cell containers are
    center-aligned, so the slot arrays shard as-is)."""
    nxl, nyl = decomp.nxl, decomp.nyl
    dx, dy = geometry.di
    ox, oy = geometry.origin
    nx, ny = particles.px.shape[:2]
    bx = (np.arange(nx) // nxl) * nxl * dx + ox
    by = (np.arange(ny) // nyl) * nyl * dy + oy
    px = np.asarray(particles.px) - bx[:, None, None]
    py = np.asarray(particles.py) - by[None, :, None]
    return particles.replace(px=jnp.asarray(px), py=jnp.asarray(py))


def unblock_particles(particles: Particles, geometry, decomp):
    """Inverse of :func:`block_particles` (positions back to global)."""
    nxl, nyl = decomp.nxl, decomp.nyl
    dx, dy = geometry.di
    ox, oy = geometry.origin
    nx, ny = particles.px.shape[:2]
    bx = (np.arange(nx) // nxl) * nxl * dx + ox
    by = (np.arange(ny) // nyl) * nyl * dy + oy
    px = np.asarray(particles.px) + bx[:, None, None]
    py = np.asarray(particles.py) + by[None, :, None]
    return particles.replace(px=jnp.asarray(px), py=jnp.asarray(py))


def local_particle_geometry(decomp, di) -> Tuple[Geometry, Geometry]:
    """(local block geometry, one-cell-extended geometry) shared by every
    device (positions are block-relative, origin 0)."""
    nxl, nyl = decomp.nxl, decomp.nyl
    dx, dy = di
    g_loc = Geometry((nxl, nyl), (nxl * dx, nyl * dy))
    g_ext = Geometry(
        (nxl + 2, nyl + 2), ((nxl + 2) * dx, (nyl + 2) * dy),
        origin=(-dx, -dy),
    )
    return g_loc, g_ext


def _extend_particles(A, shift_x, shift_y, is_position_x, is_position_y):
    """Ghost-extend a (nxl, nyl, m) slot array by one cell per side, shifting
    received positions into the local frame."""
    lo_x = halo.from_next(A[:1], "x")  # right neighbor's first column → my hi ghost
    hi_from_prev = halo.from_prev(A[-1:], "x")  # left neighbor's last column → my lo ghost
    if is_position_x:
        hi_ghost = lo_x + shift_x
        lo_ghost = hi_from_prev - shift_x
    else:
        hi_ghost = lo_x
        lo_ghost = hi_from_prev
    A = jnp.concatenate([lo_ghost, A, hi_ghost], axis=0)
    lo_y = halo.from_next(A[:, :1], "y")
    hi_from_prev_y = halo.from_prev(A[:, -1:], "y")
    if is_position_y:
        hi_ghost = lo_y + shift_y
        lo_ghost = hi_from_prev_y - shift_y
    else:
        hi_ghost = lo_y
        lo_ghost = hi_from_prev_y
    return jnp.concatenate([lo_ghost, A, hi_ghost], axis=1)


def advect_move_local(
    particles: Particles,
    fields: Dict[str, Array],
    Vx, Vy,
    decomp,
    di,
    dt,
) -> Tuple[Particles, Dict[str, Array]]:
    """Inside ``shard_map``: RK2 advection on ghost-extended local velocities,
    then cross-device migration + re-slotting. Positions are block-relative.
    """
    nxl, nyl = decomp.nxl, decomp.nyl
    dx, dy = di
    g_loc, g_ext = local_particle_geometry(decomp, di)
    lx, ly = nxl * dx, nyl * dy

    # --- advect with one extra ghost face along each component's own axis ---
    # face arrays SHARE the boundary face between neighbors, so the ghost is
    # the neighbor's PENULTIMATE face (halo.extend would duplicate the shared
    # one); physical boundaries replicate the edge (same as the serial
    # clamped bilinear).
    def _extend_faces(A, axis):
        name = ("x", "y")[axis]
        sl_pen = [slice(None)] * A.ndim
        sl_pen[axis] = slice(-2, -1)
        sl_sec = [slice(None)] * A.ndim
        sl_sec[axis] = slice(1, 2)
        lo = halo.from_prev(A[tuple(sl_pen)], name)
        hi = halo.from_next(A[tuple(sl_sec)], name)
        first, last = halo.axis_edges(name)
        sl_lo = [slice(None)] * A.ndim
        sl_lo[axis] = slice(0, 1)
        sl_hi = [slice(None)] * A.ndim
        sl_hi[axis] = slice(-1, None)
        lo = jnp.where(first, A[tuple(sl_lo)], lo)
        hi = jnp.where(last, A[tuple(sl_hi)], hi)
        return jnp.concatenate([lo, A, hi], axis=axis)

    Vx_e = _extend_faces(Vx, 0)  # (nxl+3, nyl+2): faces −1 .. nxl+1
    Vy_e = _extend_faces(Vy, 1)

    def vel(X, Y):
        # Vx: faces −dx..lx+dx along x (extended), ghosted centers −dy/2.. in y
        vx = _bilinear(Vx_e, -dx, -dy / 2, dx, dy, X, Y)
        vy = _bilinear(Vy_e, -dx / 2, -dy, dx, dy, X, Y)
        return vx, vy

    X, Y = particles.px, particles.py
    vx1, vy1 = vel(X, Y)
    Xh, Yh = X + 0.5 * dt * vx1, Y + 0.5 * dt * vy1
    vx2, vy2 = vel(Xh, Yh)
    Xn, Yn = X + dt * vx2, Y + dt * vy2

    # clamp at PHYSICAL boundaries only (device-edge masks)
    fx, lx_ = halo.axis_edges("x")
    fy, ly_ = halo.axis_edges("y")
    # same eps as the serial advect_rk2 (computed from the GLOBAL extents)
    eps = 1e-12 * max(decomp.px * lx, decomp.py * ly)
    Xn = jnp.where(fx, jnp.maximum(Xn, eps), Xn)
    Xn = jnp.where(lx_, jnp.minimum(Xn, lx - eps), Xn)
    Yn = jnp.where(fy, jnp.maximum(Yn, eps), Yn)
    Yn = jnp.where(ly_, jnp.minimum(Yn, ly - eps), Yn)
    Xn = jnp.where(particles.active, Xn, X)
    Yn = jnp.where(particles.active, Yn, Y)

    # --- migrate: ghost-extend slots, serial re-slot, keep the interior -----
    px_e = _extend_particles(Xn, lx, ly, True, False)
    py_e = _extend_particles(Yn, lx, ly, False, True)
    a_e = _extend_particles(particles.active, 0, 0, False, False)
    # physical-boundary ghosts hold clamp-copies of our own edge: deactivate
    a_e = a_e.at[0].set(jnp.where(fx, False, a_e[0]))
    a_e = a_e.at[-1].set(jnp.where(lx_, False, a_e[-1]))
    a_e = a_e.at[:, 0].set(jnp.where(fy, False, a_e[:, 0]))
    a_e = a_e.at[:, -1].set(jnp.where(ly_, False, a_e[:, -1]))
    f_e = {
        k: _extend_particles(v, 0, 0, False, False) for k, v in fields.items()
    }

    p_ext = particles.replace(px=px_e, py=py_e, active=a_e)
    p_new, f_new = move_particles(p_ext, g_ext, f_e)
    inner = (slice(1, -1), slice(1, -1))
    out = particles.replace(
        px=p_new.px[inner], py=p_new.py[inner], active=p_new.active[inner]
    )
    return out, {k: v[inner] for k, v in f_new.items()}
