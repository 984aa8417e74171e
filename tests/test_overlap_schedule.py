"""Comm/compute overlap formulation (reference ``@hide_communication``,
src/stokes/Stokes2D.jl:768-785).

Value-identity: the ``overlap=True`` split-ghost-carry formulation equals
the eager ``overlap=False`` path bitwise after one iteration (the carried
ghosts hold exactly the exchanged values; only the dataflow differs) and to
accumulated roundoff over a full solve. Whether the compiled halo
collectives are asynchronous start/done pairs on the GPU is printed by
``python chip_smoke.py --cards 4``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.models import solcx
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu.parallel import stokes2d as ps
from justrelax_tpu.parallel.decomp import Decomp2D, block_staggered
from justrelax_tpu.parallel.mesh import make_grid_mesh


def _problem(nx, ny, dtype=np.float64):
    geometry = Geometry((nx, ny), (1.0, 1.0))
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1),
        eps_abs=0.0, eps_rel=0.0,
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    decomp = Decomp2D.make((nx, ny), (2, 4))
    shapes = {
        "Vx": block_staggered(np.zeros((nx + 1, ny + 2), dtype), decomp, (1, 2)).shape,
        "Vy": block_staggered(np.zeros((nx + 2, ny + 1), dtype), decomp, (2, 1)).shape,
        "txy": block_staggered(np.zeros((nx + 1, ny + 1), dtype), decomp, (1, 1)).shape,
    }
    eta = np.asarray(solcx.solcx_viscosity(geometry, 1.0e6), dtype)
    rho = np.asarray(solcx.solcx_density(geometry), dtype)
    z = np.zeros((nx, ny), dtype)
    blocks = {
        "Vx": np.zeros(shapes["Vx"], dtype),
        "Vy": np.zeros(shapes["Vy"], dtype),
        "P": z, "P0": z, "Q": z, "txx": z, "tyy": z,
        "txy": np.zeros(shapes["txy"], dtype),
        "txx_o": z, "tyy_o": z,
        "txy_o": np.zeros(shapes["txy"], dtype),
        "eta": eta, "G": np.full((nx, ny), np.inf, dtype),
        "K": np.full((nx, ny), np.inf, dtype),
        "rho_gx": z, "rho_gy": rho,
    }
    blocks = {k: jnp.asarray(v) for k, v in blocks.items()}
    blocks["inv_dx"] = 1.0 / geometry.di[0]
    blocks["inv_dy"] = 1.0 / geometry.di[1]
    return pt, bc, decomp, blocks


@pytest.mark.slow
def test_overlap_path_bit_identical():
    """Split-ghost-carry (overlap=True) == eager exchange (overlap=False).

    The semantic claim — the carried ghost slices hold exactly the values an
    eager exchange would install — is asserted BITWISE after one iteration
    (every field, including the ghost/duplicate layers of the gathered
    blocks). Over many iterations the two formulations are different HLO
    programs, and XLA CPU's fusion-dependent FMA contraction legally differs
    between them (measured: 1-ulp spread appearing from iteration 2), so
    long-run equivalence is asserted at accumulated-roundoff tolerance
    (~1e-15 vs the ~1e-4 solution scale) rather than bitwise.
    """
    mesh = make_grid_mesh((2, 4))
    pt, bc, decomp, blocks = _problem(32, 32)

    def run(nit, nout, overlap):
        return ps.solve_ve_sharded(
            mesh, decomp, dict(blocks), pt, bc, 0.1,
            iter_max=nit, nout=nout, overlap=overlap,
        )

    r1, r0 = run(1, 1, True), run(1, 1, False)
    for name in ("Vx", "Vy", "P", "txx", "tyy", "txy"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r1, name)), np.asarray(getattr(r0, name)),
            err_msg=f"{name} ghost dataflow differs after one iteration",
        )

    r1, r0 = run(1000, 250, True), run(1000, 250, False)
    for name in ("Vx", "Vy", "P", "txx", "tyy", "txy"):
        np.testing.assert_allclose(
            np.asarray(getattr(r1, name)), np.asarray(getattr(r0, name)),
            rtol=0.0, atol=5e-15,
            err_msg=f"{name} differs between overlap paths",
        )
