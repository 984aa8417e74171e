"""Staggered Cartesian grid geometry.

JAX-native equivalent of the reference's ``Geometry`` struct
(/root/reference/src/grid/Grid.jl:28-46): a uniform (for now) staggered grid
holding cell counts, domain lengths, origin, spacings and the coordinate
vectors for cell centers, vertices and the ghosted velocity grids.

Geometry is *static metadata*: it is a frozen Python dataclass of plain floats
and numpy arrays, closed over by jitted solver functions (never traced). The
distributed variant (local subdomain of a global grid on a device mesh) lives
in :mod:`justrelax_tpu.parallel.grid`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["Geometry", "NonuniformGeometry", "velocity_grids"]


def _lazy_grid(di, ni, li, origin):
    """Cell-center and vertex coordinate vectors of a uniform grid.

    Mirrors reference lazy_grid (src/grid/Grid.jl:262-283).
    """
    ndim = len(ni)
    xci = tuple(
        np.linspace(origin[d] + di[d] / 2, origin[d] + li[d] - di[d] / 2, ni[d])
        for d in range(ndim)
    )
    xvi = tuple(
        np.linspace(origin[d], origin[d] + li[d], ni[d] + 1) for d in range(ndim)
    )
    return xci, xvi


def velocity_grids(xci, xvi, di):
    """Coordinates of the staggered velocity nodes (ghosted transverse axes).

    For each velocity component the along-component axis lives on vertices and
    every transverse axis is the cell-center axis extended by one ghost node on
    each side (reference src/grid/Grid.jl:316-330).
    """
    ndim = len(xci)
    ghosted = tuple(
        np.concatenate(([xci[d][0] - di[d]], xci[d], [xci[d][-1] + di[d]]))
        for d in range(ndim)
    )
    return tuple(
        tuple(xvi[d] if d == comp else ghosted[d] for d in range(ndim))
        for comp in range(ndim)
    )


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A uniform staggered grid in 2 or 3 dimensions.

    Attributes
    ----------
    ni : number of cells per dimension.
    li : physical domain length per dimension.
    origin : lower corner of the domain.
    di : cell spacing per dimension.
    max_li / min_li : max/min domain extent (used by PT coefficient math).
    xci / xvi : cell-center / vertex coordinate vectors (numpy, host-side).
    xi_vel : per-velocity-component coordinate vectors (ghosted transverse).
    """

    ni: Tuple[int, ...]
    li: Tuple[float, ...]
    origin: Tuple[float, ...]
    di: Tuple[float, ...]
    xci: Tuple[np.ndarray, ...]
    xvi: Tuple[np.ndarray, ...]
    xi_vel: Tuple[Tuple[np.ndarray, ...], ...]

    def __init__(
        self,
        ni: Tuple[int, ...],
        li: Tuple[float, ...],
        origin: Optional[Tuple[float, ...]] = None,
    ):
        ndim = len(ni)
        if ndim not in (2, 3):
            raise ValueError(f"Geometry supports 2D/3D, got ndim={ndim}")
        if len(li) != ndim:
            raise ValueError("ni and li must have the same length")
        ni = tuple(int(n) for n in ni)
        li = tuple(float(l) for l in li)
        if origin is None:
            origin = (0.0,) * ndim
        origin = tuple(float(o) for o in origin)
        di = tuple(li[d] / ni[d] for d in range(ndim))
        xci, xvi = _lazy_grid(di, ni, li, origin)
        xi_vel = velocity_grids(xci, xvi, di)
        object.__setattr__(self, "ni", ni)
        object.__setattr__(self, "li", li)
        object.__setattr__(self, "origin", origin)
        object.__setattr__(self, "di", di)
        object.__setattr__(self, "xci", xci)
        object.__setattr__(self, "xvi", xvi)
        object.__setattr__(self, "xi_vel", xi_vel)

    # Geometry is passed as a *static* argument to jitted solvers: hash/eq on
    # the defining scalars only (coordinate vectors are derived from them).
    def __hash__(self):
        return hash((self.ni, self.li, self.origin))

    def __eq__(self, other):
        return (
            isinstance(other, Geometry)
            and self.ni == other.ni
            and self.li == other.li
            and self.origin == other.origin
        )

    # --- derived quantities -------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.ni)

    @property
    def max_li(self) -> float:
        return max(self.li)

    @property
    def min_li(self) -> float:
        return min(self.li)

    @property
    def min_di(self) -> float:
        return min(self.di)

    @property
    def inv_di(self) -> Tuple[float, ...]:
        return tuple(1.0 / d for d in self.di)

    def cell_centers_mesh(self, indexing: str = "ij"):
        """Dense meshgrid of cell-center coordinates."""
        return np.meshgrid(*self.xci, indexing=indexing)

    def vertices_mesh(self, indexing: str = "ij"):
        """Dense meshgrid of vertex coordinates."""
        return np.meshgrid(*self.xvi, indexing=indexing)


@dataclasses.dataclass(frozen=True, init=False)
class NonuniformGeometry(Geometry):
    """A staggered grid with per-axis vector spacing (reference Grid.jl
    nonuniform constructor, Grid.jl:69-131 + velocity_grids vector variants
    at :272-316).

    Built from per-axis VERTEX coordinate vectors. Adds the named spacing
    families the nonuniform kernels need:

    - ``di_center[d]``  (ni[d],)   : cell widths  xv[i+1] − xv[i]
      (divergence / cell updates);
    - ``di_vertex[d]``  (ni[d]+1,) : face spacings xc[i] − xc[i−1], clamped
      to the edge cell width at the two boundary faces (gradients/fluxes).

    ``di`` holds the MINIMUM spacing per axis (conservative CFL / PT
    coefficients). Hash/eq include the coordinates, so each distinct grid
    compiles its own kernel (spacings are baked in as constants).
    """

    di_center: Tuple[Tuple[float, ...], ...]
    di_vertex: Tuple[Tuple[float, ...], ...]

    def __init__(self, vertex_coords):
        xvi = tuple(np.asarray(v, dtype=float) for v in vertex_coords)
        ndim = len(xvi)
        if ndim not in (2, 3):
            raise ValueError(f"NonuniformGeometry supports 2D/3D, got {ndim}")
        for v in xvi:
            if v.ndim != 1 or v.size < 2 or np.any(np.diff(v) <= 0):
                raise ValueError(
                    "vertex coordinates must be strictly increasing 1D vectors"
                )
        ni = tuple(int(v.size - 1) for v in xvi)
        origin = tuple(float(v[0]) for v in xvi)
        li = tuple(float(v[-1] - v[0]) for v in xvi)
        xci = tuple(0.5 * (v[1:] + v[:-1]) for v in xvi)
        dc = tuple(np.diff(v) for v in xvi)
        dv = tuple(
            np.concatenate(([d[0]], np.diff(c), [d[-1]]))
            for c, d in zip(xci, dc)
        )
        di_min = tuple(float(d.min()) for d in dc)
        # ghost offsets use the edge cell widths (reference velocity_grids
        # vector variant, Grid.jl:272-284)
        ghosted = tuple(
            np.concatenate(([c[0] - d[0]], c, [c[-1] + d[-1]]))
            for c, d in zip(xci, dc)
        )
        xi_vel = tuple(
            tuple(xvi[d] if d == comp else ghosted[d] for d in range(ndim))
            for comp in range(ndim)
        )
        object.__setattr__(self, "ni", ni)
        object.__setattr__(self, "li", li)
        object.__setattr__(self, "origin", origin)
        object.__setattr__(self, "di", di_min)
        object.__setattr__(self, "xci", xci)
        object.__setattr__(self, "xvi", xvi)
        object.__setattr__(self, "xi_vel", xi_vel)
        object.__setattr__(self, "di_center", tuple(tuple(map(float, d)) for d in dc))
        object.__setattr__(self, "di_vertex", tuple(tuple(map(float, d)) for d in dv))

    def __hash__(self):
        return hash((self.ni, self.di_center, self.origin))

    def __eq__(self, other):
        return (
            isinstance(other, NonuniformGeometry)
            and self.ni == other.ni
            and self.origin == other.origin
            and self.di_center == other.di_center
        )

    def _bcast(self, vecs, ndim):
        out = []
        for d, v in enumerate(vecs):
            shape = [1] * ndim
            shape[d] = len(v)
            out.append(np.asarray(v, dtype=float).reshape(shape))
        return tuple(out)

    @property
    def inv_flux_di(self):
        """Broadcastable 1/spacing arrays for face gradients (flux)."""
        return tuple(
            1.0 / a for a in self._bcast(self.di_vertex, len(self.ni))
        )

    @property
    def inv_div_di(self):
        """Broadcastable 1/spacing arrays for cell divergences."""
        return tuple(
            1.0 / a for a in self._bcast(self.di_center, len(self.ni))
        )
