"""Distributed solver vs serial: bit-comparable results on the same global grid
(the JAX analogue of the reference's *_MPI.jl gather-and-compare tests)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.models import solcx
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu.parallel.decomp import Decomp2D, block_staggered, unblock_staggered
from justrelax_tpu.parallel.mesh import make_grid_mesh
from justrelax_tpu.parallel.stokes2d import solve_ve_sharded
from justrelax_tpu.solvers.stokes2d import solve_ve


def test_block_roundtrip():
    d = Decomp2D.make((8, 8), (2, 4))
    rng = np.random.default_rng(0)
    for extra in [(0, 0), (1, 1), (1, 2), (2, 1), (2, 2)]:
        A = rng.standard_normal((8 + extra[0], 8 + extra[1]))
        B = block_staggered(A, d, extra)
        A2 = unblock_staggered(B, d, extra)
        np.testing.assert_array_equal(A, A2)


@pytest.mark.slow
def test_sharded_solcx_matches_serial():
    nx = ny = 32
    n_chunks = 4
    nout = 250
    geometry, _, _, _ = solcx.run(nx=2, ny=2, iter_max=1, nout=1)  # warm import only

    from justrelax_tpu.core.grid import Geometry

    geometry = Geometry((nx, ny), (1.0, 1.0))
    eta = solcx.solcx_viscosity(geometry, 1.0e6)
    rho = solcx.solcx_density(geometry)

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0, eps_rel=0.0
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    # --- serial reference run (fixed n_chunks iterations) ------------------
    stokes = StokesState.make((nx, ny))
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.asarray(eta))
    )
    rho_g = (jnp.zeros((nx, ny)), jnp.asarray(rho))
    G = jnp.full((nx, ny), jnp.inf)
    K = jnp.full((nx, ny), jnp.inf)
    serial, info = solve_ve(
        stokes, pt, geometry, bc, rho_g, G, K, 0.1,
        iter_max=n_chunks * nout, nout=nout,
    )
    assert int(info.iters) == n_chunks * nout

    # --- sharded run on an 8-device virtual mesh ---------------------------
    mesh = make_grid_mesh((2, 4))
    decomp = Decomp2D.make((nx, ny), (2, 4))
    z = np.zeros((nx, ny))
    blocks_np = {
        "Vx": block_staggered(np.zeros((nx + 1, ny + 2)), decomp, (1, 2)),
        "Vy": block_staggered(np.zeros((nx + 2, ny + 1)), decomp, (2, 1)),
        "P": z, "P0": z, "Q": z,
        "txx": z, "tyy": z,
        "txy": block_staggered(np.zeros((nx + 1, ny + 1)), decomp, (1, 1)),
        "txx_o": z, "tyy_o": z,
        "txy_o": block_staggered(np.zeros((nx + 1, ny + 1)), decomp, (1, 1)),
        "eta": np.asarray(eta),
        "G": np.full((nx, ny), np.inf),
        "K": np.full((nx, ny), np.inf),
        "rho_gx": z,
        "rho_gy": np.asarray(rho),
    }
    blocks = {k: jnp.asarray(v) for k, v in blocks_np.items()}
    blocks["inv_dx"] = 1.0 / geometry.di[0]
    blocks["inv_dy"] = 1.0 / geometry.di[1]
    res = solve_ve_sharded(
        mesh, decomp, blocks, pt, bc, 0.1, iter_max=n_chunks * nout, nout=nout
    )
    assert int(res.iters) == n_chunks * nout

    P_g = unblock_staggered(np.asarray(res.P), decomp, (0, 0))
    Vx_g = unblock_staggered(np.asarray(res.Vx), decomp, (1, 2))
    Vy_g = unblock_staggered(np.asarray(res.Vy), decomp, (2, 1))
    txy_g = unblock_staggered(np.asarray(res.txy), decomp, (1, 1))

    np.testing.assert_allclose(P_g, np.asarray(serial.P), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Vx_g, np.asarray(serial.V.Vx), rtol=0, atol=1e-14)
    np.testing.assert_allclose(Vy_g, np.asarray(serial.V.Vy), rtol=0, atol=1e-14)
    np.testing.assert_allclose(txy_g, np.asarray(serial.tau.xy), rtol=0, atol=1e-12)
    # shared faces/vertices consistent across duplicates
    assert np.isfinite(float(res.err))


@pytest.mark.slow
def test_sharded_ve_full_terms_matches_serial():
    """Pin EVERY term of the distributed VE twin against the serial kernels
    (round-1 review: serial/parallel kernel duplication is a drift risk —
    this test makes drift unpassable): finite G (elastic memory tau_o != 0),
    finite K (compressible), nonzero Q source, gravity in BOTH components,
    spatially varying viscosity, and a second mesh layout (4x2)."""
    nx = ny = 32
    n_chunks = 3
    nout = 200
    from justrelax_tpu.core.grid import Geometry

    geometry = Geometry((nx, ny), (1.0, 1.0))
    rng = np.random.default_rng(7)
    eta = np.exp(rng.uniform(0.0, 2.0, (nx, ny)))  # smooth-ish contrast
    rho_x = 0.3 * rng.standard_normal((nx, ny))
    rho_y = 1.0 + 0.2 * rng.standard_normal((nx, ny))
    Qs = 0.05 * rng.standard_normal((nx, ny))
    txx_o = 0.1 * rng.standard_normal((nx, ny))
    tyy_o = 0.1 * rng.standard_normal((nx, ny))
    txy_o = 0.1 * rng.standard_normal((nx + 1, ny + 1))

    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1), eps_abs=0.0, eps_rel=0.0
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    stokes = StokesState.make((nx, ny))
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.asarray(eta)),
        Q=jnp.asarray(Qs),
        tau_o=stokes.tau_o.replace(
            xx=jnp.asarray(txx_o), yy=jnp.asarray(tyy_o), xy=jnp.asarray(txy_o)
        ),
    )
    rho_g = (jnp.asarray(rho_x), jnp.asarray(rho_y))
    G = jnp.full((nx, ny), 5.0)
    K = jnp.full((nx, ny), 8.0)
    dt = 0.25
    serial, info = solve_ve(
        stokes, pt, geometry, bc, rho_g, G, K, dt,
        iter_max=n_chunks * nout, nout=nout,
    )
    assert int(info.iters) == n_chunks * nout

    mesh = make_grid_mesh((4, 2))
    decomp = Decomp2D.make((nx, ny), (4, 2))
    z = np.zeros((nx, ny))
    blocks_np = {
        "Vx": block_staggered(np.zeros((nx + 1, ny + 2)), decomp, (1, 2)),
        "Vy": block_staggered(np.zeros((nx + 2, ny + 1)), decomp, (2, 1)),
        "P": z, "P0": z, "Q": np.asarray(Qs),
        "txx": z, "tyy": z,
        "txy": block_staggered(np.zeros((nx + 1, ny + 1)), decomp, (1, 1)),
        "txx_o": np.asarray(txx_o), "tyy_o": np.asarray(tyy_o),
        "txy_o": block_staggered(np.asarray(txy_o), decomp, (1, 1)),
        "eta": np.asarray(eta),
        "G": np.full((nx, ny), 5.0),
        "K": np.full((nx, ny), 8.0),
        "rho_gx": np.asarray(rho_x),
        "rho_gy": np.asarray(rho_y),
    }
    blocks = {k: jnp.asarray(v) for k, v in blocks_np.items()}
    blocks["inv_dx"] = 1.0 / geometry.di[0]
    blocks["inv_dy"] = 1.0 / geometry.di[1]
    res = solve_ve_sharded(
        mesh, decomp, blocks, pt, bc, dt, iter_max=n_chunks * nout, nout=nout
    )
    assert int(res.iters) == n_chunks * nout

    P_g = unblock_staggered(np.asarray(res.P), decomp, (0, 0))
    Vx_g = unblock_staggered(np.asarray(res.Vx), decomp, (1, 2))
    Vy_g = unblock_staggered(np.asarray(res.Vy), decomp, (2, 1))
    txx_g = unblock_staggered(np.asarray(res.txx), decomp, (0, 0))
    tyy_g = unblock_staggered(np.asarray(res.tyy), decomp, (0, 0))
    txy_g = unblock_staggered(np.asarray(res.txy), decomp, (1, 1))

    np.testing.assert_allclose(P_g, np.asarray(serial.P), rtol=0, atol=1e-13)
    np.testing.assert_allclose(Vx_g, np.asarray(serial.V.Vx), rtol=0, atol=1e-14)
    np.testing.assert_allclose(Vy_g, np.asarray(serial.V.Vy), rtol=0, atol=1e-14)
    np.testing.assert_allclose(txx_g, np.asarray(serial.tau.xx), rtol=0, atol=1e-13)
    np.testing.assert_allclose(tyy_g, np.asarray(serial.tau.yy), rtol=0, atol=1e-13)
    np.testing.assert_allclose(txy_g, np.asarray(serial.tau.xy), rtol=0, atol=1e-13)
