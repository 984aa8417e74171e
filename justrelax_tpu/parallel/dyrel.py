"""Distributed DYREL Stokes solver (multi-device GSPMD path).

The reference runs DYREL under MPI with batched vertex-stress halo exchanges
and V halos inside the inner dynamic-relaxation loop
(/root/reference/src/DYREL/solver.jl:199-206,225-226) plus MPI-reduced norms.

The JAX-native re-design needs none of that by hand: ``solve_dyrel``
(solvers/dyrel.py) is built entirely from static-slice stencils, global
reductions, and ``lax.while_loop`` — exactly the program class XLA's SPMD
partitioner shards automatically. The distributed entry point wraps the
*same* solver in a jit that pins every center-shaped field (shape divisible
by the mesh) to a ("x","y") ``NamedSharding``; GSPMD propagates the sharding
to the staggered (n+1 / n+2) arrays with halo padding, turns each shifted
slice into a neighbor ``collective-permute`` over ICI (the ``update_halo!``
analogue, scheduled by the latency-hiding scheduler, cf.
tests/test_overlap_schedule.py), and lowers each norm/Rayleigh-quotient
reduction to an ``all-reduce`` (``norm_mpi`` analogue). Zero kernel
duplication with the serial path — the divergence risk the round-1 review
flagged for hand-sharded twins cannot exist here.

Parity: tests/test_distributed_dyrel.py proves sharded == serial on the
8-device CPU mesh and that the outputs really are distributed.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from justrelax_tpu.solvers.dyrel import solve_dyrel

Array = Any

__all__ = ["solve_dyrel_sharded"]


def _constrainer(mesh: Mesh):
    """Sharding constraint for grid leaves: spatial axes over the mesh,
    trailing (phase) axes local; leaves whose spatial extents don't divide
    the mesh (staggered n+1/n+2 shapes) are left to GSPMD propagation."""
    ax, ay = mesh.axis_names
    px, py = mesh.shape[ax], mesh.shape[ay]

    def constrain(x):
        if getattr(x, "ndim", 0) >= 2 and x.shape[0] % px == 0 and x.shape[1] % py == 0:
            spec = P(ax, ay, *(None,) * (x.ndim - 2))
            return lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
        return x

    return constrain


def solve_dyrel_sharded(
    mesh: Mesh,
    stokes,
    geometry,
    flow_bc,
    material,
    pr_center: Array,
    pr_vertex: Array,
    dt,
    rho_g: Optional[Tuple[Array, Array]] = None,
    **kwargs,
):
    """``solve_dyrel`` distributed over ``mesh`` ("x","y").

    Same signature as the serial solver plus the mesh; returns the solved
    state with device-resident sharded leaves (``np.asarray`` gathers).
    """
    if len(mesh.axis_names) != 2:
        raise ValueError("solve_dyrel_sharded expects a 2D ('x','y') mesh")
    constrain = _constrainer(mesh)

    @jax.jit
    def run(stokes, pr_c, pr_v, dt, rho_g):
        stokes = jax.tree_util.tree_map(constrain, stokes)
        pr_c = constrain(pr_c)
        pr_v = constrain(pr_v)
        if rho_g is not None:
            rho_g = tuple(constrain(r) for r in rho_g)
        return solve_dyrel(
            stokes, geometry, flow_bc, material, pr_c, pr_v, dt,
            rho_g=rho_g, **kwargs,
        )

    return run(stokes, pr_center, pr_vertex, dt, rho_g)
