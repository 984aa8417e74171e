"""Multi-host distributed bring-up (the ImplicitGlobalGrid/MPI analogue).

The reference initializes MPI, builds a Cartesian communicator, and allocates
rank-local blocks (src/grid/Grid.jl:18-46,157-217 via
``init_global_grid``); its CI proves 2 nodes x 4 GPUs
(ci/cscs-gh200.yml:28-35). The JAX-native equivalents here:

- :func:`initialize` — ``jax.distributed.initialize`` wrapper (MPI_Init):
  one JAX process per host; after it, ``jax.devices()`` is the GLOBAL device
  list and collectives ride ICI within a host slice / DCN across hosts.
- :func:`make_multihost_grid_mesh` — DCN-aware mesh construction: hosts are
  laid along the FIRST ("x") mesh axis, each host's local devices along the
  remaining axes. A radius-1 halo exchange then crosses DCN only on the two
  x-facing block faces per host — the layout the reference gets from
  ImplicitGlobalGrid's cartesian communicator — while the high-frequency
  y/z exchanges stay on ICI.
- :func:`blocks_from_tiles` — per-host block initialization: a callback
  produces the block-local tile for one device; tiles are only materialized
  for the host's addressable devices (``jax.make_array_from_callback``), so
  no process ever holds the global grid — the IGG idiom of allocating only
  rank-local arrays.
- :func:`gather_blocked` — gather a blocked distributed array to every host
  (the reference tests' ``gather!`` onto rank 0,
  test/test_shearband2D_MPI.jl) for verification/IO.

Proven by tests/test_multihost.py: a subprocess-spawned 2-process x
4-CPU-device run of the sharded VE solver reproduces the serial solver
(the ``mpiexec -n 2`` tier of the reference's runtests.jl:48-89).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = Any

__all__ = [
    "initialize",
    "make_multihost_grid_mesh",
    "blocks_from_tiles",
    "blocks_from_global",
    "gather_blocked",
    "process_count",
    "process_index",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-process JAX runtime (reference ``MPI.Init`` +
    ``init_global_grid``). Arguments default to the standard environment
    variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); a single-process environment is a no-op. Safe to
    call twice."""
    if jax._src.distributed.global_state.client is not None:  # already up
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address, num_processes=num_processes, process_id=process_id
    )


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def make_multihost_grid_mesh(
    ndim: int = 2,
    local_shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Spatial ("x","y"[,"z"]) mesh with hosts stacked along the first axis.

    ``local_shape`` factors each host's local devices over the trailing
    axes (default: all local devices along the last axis). The global mesh
    shape is ``(procs · lx, ly[, lz])`` where ``local_shape = (lx, ly[, lz])``
    — device (i, j[, k]) belongs to host ``i // lx``, so x-halo exchanges
    cross DCN at host boundaries only and all other traffic is ICI-local.
    """
    procs = jax.process_count()
    n_local = jax.local_device_count()
    if local_shape is None:
        local_shape = (1,) * (ndim - 1) + (n_local,)
    local_shape = tuple(int(s) for s in local_shape)
    if int(np.prod(local_shape)) != n_local:
        raise ValueError(
            f"local_shape {local_shape} does not cover {n_local} local devices"
        )
    # order devices host-major so reshape puts each host's devices in a
    # contiguous x-slab
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    shape = (procs * local_shape[0],) + local_shape[1:]
    axis_names = ("x", "y", "z")[: len(shape)]
    return Mesh(np.asarray(devs).reshape(shape), axis_names)


def blocks_from_tiles(
    mesh: Mesh,
    block_shape: Tuple[int, ...],
    tile_fn: Callable[[Tuple[int, ...]], np.ndarray],
    dtype=None,
) -> Array:
    """Build a blocked-local distributed array from a per-device tile
    callback (per-host initialization: ``tile_fn`` runs only for this
    host's addressable devices).

    ``block_shape`` is the per-device tile shape; ``tile_fn(coords)`` gets
    the device's mesh coordinates (e.g. ``(ix, iy)``) and returns its tile.
    """
    mesh_shape = mesh.devices.shape
    global_shape = tuple(
        b * m for b, m in zip(block_shape, mesh_shape)
    ) + tuple(block_shape[len(mesh_shape):])
    sharding = NamedSharding(mesh, P(*mesh.axis_names))

    def cb(index):
        coords = tuple(
            (sl.start or 0) // b for sl, b in zip(index, block_shape)
        )
        tile = np.asarray(tile_fn(coords))
        return tile if dtype is None else tile.astype(dtype)

    return jax.make_array_from_callback(global_shape, sharding, cb)


def blocks_from_global(
    mesh: Mesh,
    blocked_np: np.ndarray,
    dtype=None,
) -> Array:
    """Distribute an already-blocked numpy array (``decomp.block_staggered``
    layout) — every host holds the full array but uploads only its shards.
    Convenience for tests; production initialization should use
    :func:`blocks_from_tiles`."""
    mesh_shape = mesh.devices.shape
    block = tuple(
        s // m for s, m in zip(blocked_np.shape, mesh_shape)
    )
    sharding = NamedSharding(mesh, P(*mesh.axis_names))

    def cb(index):
        tile = blocked_np[tuple(index)]
        return tile if dtype is None else tile.astype(dtype)

    return jax.make_array_from_callback(blocked_np.shape, sharding, cb)


def gather_blocked(A: Array) -> np.ndarray:
    """All-gather a blocked distributed array onto every host (reference
    ``gather!`` to rank 0, test/test_shearband2D_MPI.jl tail)."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.asarray(A)
    return np.asarray(multihost_utils.process_allgather(A, tiled=True))
