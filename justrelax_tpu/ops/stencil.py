"""Vectorized staggered-grid stencil primitives.

JAX-native counterpart of the reference's per-index mini-kernels
(/root/reference/src/MiniKernels.jl). Instead of scalar index arithmetic inside
a launched kernel, each primitive is a whole-array slice expression that XLA
fuses into the surrounding computation (and that Pallas kernels reuse
blockwise). All operate on the leading two (or three) axes with axis order
``(x, y[, z])``.

Naming convention (matching the reference):
- ``d_xa(A)``  : aligned forward difference along x → shape loses 1 in x.
- ``d_xi(A)``  : "inner" difference along x: difference of x-neighbors taken
  one node into the array along every *other* axis (used for velocity arrays
  with ghost transverse rows).
- ``av_xa``/``av_ya`` : 2-point arithmetic averages along one axis.
- ``av_a``     : 4-point (2D) / 8-point (3D) average onto the dual grid.
- ``harm_a``   : harmonic 4/8-point average.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "d_xa",
    "d_ya",
    "d_za",
    "d_xi",
    "d_yi",
    "d_zi",
    "av_xa",
    "av_ya",
    "av_za",
    "av_a",
    "harm_a",
    "av_vertex_to_center",
    "av_center_to_vertex",
    "maxloc",
    "expand_edges",
]


# --- aligned differences ----------------------------------------------------
def d_xa(A, _dx=1.0):
    return (A[1:, ...] - A[:-1, ...]) * _dx


def d_ya(A, _dy=1.0):
    return (A[:, 1:, ...] - A[:, :-1, ...]) * _dy


def d_za(A, _dz=1.0):
    return (A[:, :, 1:] - A[:, :, :-1]) * _dz


# --- inner differences (skip ghost layers on transverse axes) ---------------
def d_xi(A, _dx=1.0):
    """2D: (A[i+1, j+1] - A[i, j+1]) — x-difference on interior rows."""
    if A.ndim == 2:
        return (A[1:, 1:] - A[:-1, 1:]) * _dx
    return (A[1:, 1:, 1:] - A[:-1, 1:, 1:]) * _dx


def d_yi(A, _dy=1.0):
    """2D: (A[i+1, j+1] - A[i+1, j]) — y-difference on interior columns."""
    if A.ndim == 2:
        return (A[1:, 1:] - A[1:, :-1]) * _dy
    return (A[1:, 1:, 1:] - A[1:, :-1, 1:]) * _dy


def d_zi(A, _dz=1.0):
    return (A[1:, 1:, 1:] - A[1:, 1:, :-1]) * _dz


# --- averages ---------------------------------------------------------------
def av_xa(A):
    return 0.5 * (A[1:, ...] + A[:-1, ...])


def av_ya(A):
    return 0.5 * (A[:, 1:, ...] + A[:, :-1, ...])


def av_za(A):
    return 0.5 * (A[:, :, 1:] + A[:, :, :-1])


def av_a(A):
    """Average onto the dual grid: 4-point in 2D, 8-point in 3D.

    Shape shrinks by one along every axis (centers → interior vertices, or
    vertices → centers).
    """
    if A.ndim == 2:
        return 0.25 * (A[:-1, :-1] + A[1:, :-1] + A[:-1, 1:] + A[1:, 1:])
    return 0.125 * (
        A[:-1, :-1, :-1]
        + A[1:, :-1, :-1]
        + A[:-1, 1:, :-1]
        + A[:-1, :-1, 1:]
        + A[1:, 1:, :-1]
        + A[1:, :-1, 1:]
        + A[:-1, 1:, 1:]
        + A[1:, 1:, 1:]
    )


def harm_a(A):
    """Harmonic dual-grid average (4-point 2D / 8-point 3D)."""
    if A.ndim == 2:
        s = 1.0 / A[:-1, :-1] + 1.0 / A[1:, :-1] + 1.0 / A[:-1, 1:] + 1.0 / A[1:, 1:]
        return 4.0 / s
    s = (
        1.0 / A[:-1, :-1, :-1]
        + 1.0 / A[1:, :-1, :-1]
        + 1.0 / A[:-1, 1:, :-1]
        + 1.0 / A[:-1, :-1, 1:]
        + 1.0 / A[1:, 1:, :-1]
        + 1.0 / A[1:, :-1, 1:]
        + 1.0 / A[:-1, 1:, 1:]
        + 1.0 / A[1:, 1:, 1:]
    )
    return 8.0 / s


def av_vertex_to_center(A):
    """(nx+1, ny+1[, nz+1]) vertices → (nx, ny[, nz]) centers."""
    return av_a(A)


def expand_edges(A):
    """Pad by one node on every face replicating edge values (clamped index)."""
    pad = tuple((1, 1) for _ in range(A.ndim))
    return jnp.pad(A, pad, mode="edge")


def av_center_to_vertex(A):
    """(nx, ny[, nz]) centers → (nx+1, ny+1[, nz+1]) vertices.

    Boundary vertices use edge-clamped neighbor values, matching the
    reference's clamped-average interpolation (Interpolations.jl
    ``center2vertex!`` with boundary clamping).
    """
    return av_a(expand_edges(A))


def maxloc(A, window=1):
    """Windowed local maximum with clamped boundaries.

    Reference ``compute_maxloc!`` (src/Utils.jl:409-437): B[i] = max of A over
    the (2w+1)^ndim window centered at i, window indices clamped into the
    array. Used as the PT preconditioner ``ητ``.
    """
    B = A
    for axis in range(A.ndim):
        parts = [B]
        for s in range(1, window + 1):
            up = jnp.concatenate(
                [
                    jax_slice(B, axis, s, None),
                    jnp.repeat(jax_slice(B, axis, -1, None), s, axis=axis),
                ],
                axis=axis,
            )
            dn = jnp.concatenate(
                [
                    jnp.repeat(jax_slice(B, axis, 0, 1), s, axis=axis),
                    jax_slice(B, axis, None, -s),
                ],
                axis=axis,
            )
            parts.extend([up, dn])
        B = jnp.max(jnp.stack(parts), axis=0)
    return B


def jax_slice(A, axis, start, stop):
    idx = [slice(None)] * A.ndim
    if start == -1 and stop is None:
        idx[axis] = slice(-1, None)
    else:
        idx[axis] = slice(start, stop)
    return A[tuple(idx)]


# --- interior-slab updates (pad+add / mask+set idiom) -----------------------
# A ``.at[1:-1, ...].add(inc)`` lowers to a dynamic-update-slice that XLA
# may not fuse with the producer of ``inc``. A zero-pad fuses into the
# elementwise add; a broadcasted-iota mask fuses into a select.


def interior_add(A, inc, pads=None):
    """``A.at[interior].add(inc)`` as fusable pad+add.

    ``pads`` defaults to one layer on every axis; pass a jnp.pad-style tuple
    to pad a subset of axes (e.g. ``((0, 0), (1, 1))`` for ``A.at[:, 1:-1]``).
    """
    if pads is None:
        pads = tuple((1, 1) for _ in range(A.ndim))
    return A + jnp.pad(inc, pads)


def interior_set(A, val, pads=None):
    """``A.at[interior].set(val)`` as fusable mask+select."""
    if pads is None:
        pads = tuple((1, 1) for _ in range(A.ndim))
    mask = None
    for ax, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        i = lax.broadcasted_iota(jnp.int32, A.shape, ax)
        m = (i >= lo) & (i < A.shape[ax] - hi)
        mask = m if mask is None else (mask & m)
    if mask is None:
        return val
    return jnp.where(mask, jnp.pad(val, pads), A)
