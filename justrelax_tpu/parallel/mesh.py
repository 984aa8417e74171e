"""Device-mesh domain decomposition.

The reference scales by sharding the *spatial grid* over MPI ranks
(ImplicitGlobalGrid; SURVEY.md §2.2) — the only parallelism in a stencil
solver. The JAX-native equivalent is a ``jax.sharding.Mesh`` with named axes
("x", "y"[, "z"]): every grid array is sharded along its spatial axes with a
``NamedSharding``, and XLA's SPMD partitioner automatically turns the shifted
slices of the stencil kernels into neighbor collective-permutes over ICI —
the reference's ``update_halo!`` with zero hand-written communication.

The hand-optimized halo-exchange path (``shard_map`` + ``lax.ppermute`` with
interior/boundary split for comm/compute overlap, reference
``@hide_communication``) lives in halo.py.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_grid_mesh",
    "grid_sharding",
    "shard_pytree",
    "factor_devices",
]


def factor_devices(n: int, ndim: int) -> Tuple[int, ...]:
    """Near-square factorization of ``n`` devices over ``ndim`` mesh axes."""
    dims = [1] * ndim
    remaining = n
    for d in range(ndim):
        target = round(remaining ** (1.0 / (ndim - d)))
        f = max(1, target)
        while remaining % f != 0:
            f -= 1
        dims[d] = f
        remaining //= f
    dims[-1] *= remaining
    return tuple(dims)


_AXES = ("x", "y", "z")


def make_grid_mesh(
    shape: Optional[Sequence[int]] = None,
    ndim: int = 2,
    devices=None,
) -> Mesh:
    """Create a spatial device mesh with axes ("x","y"[,"z"])."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = factor_devices(n, ndim)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, _AXES[: len(shape)])


def grid_sharding(mesh: Mesh, ndim: Optional[int] = None) -> NamedSharding:
    """NamedSharding partitioning the leading spatial axes over the mesh."""
    axes = mesh.axis_names
    if ndim is not None and ndim < len(axes):
        axes = axes[:ndim]
    return NamedSharding(mesh, P(*axes))


def shard_pytree(tree, mesh: Mesh):
    """Place every array leaf of a state pytree on the mesh, sharded along its
    spatial (leading) axes. Scalars/small arrays are replicated."""
    sh = grid_sharding(mesh)
    rep = NamedSharding(mesh, P())

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= len(mesh.axis_names):
            return jax.device_put(x, sh)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)
