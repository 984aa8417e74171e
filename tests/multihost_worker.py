"""Worker for tests/test_multihost.py: one JAX process of a 2-process x
4-CPU-device distributed VE Stokes solve (the reference's ``mpiexec -n 2``
tier, test/runtests.jl:48-89). Spawned as:

    python multihost_worker.py <process_id> <out.npz> <coordinator_port>

Process 0 writes the gathered global fields to <out.npz>. Each worker runs
on the CPU only (``JAX_PLATFORMS=cpu``, four virtual devices); nothing here
opens a GPU.
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    out_path = sys.argv[2]
    port = int(sys.argv[3]) if len(sys.argv) > 3 else 47552
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from justrelax_tpu.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
    assert jax.process_count() == 2 and len(jax.devices()) == 8

    import math

    import jax.numpy as jnp
    import numpy as np

    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.models import solcx
    from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions
    from justrelax_tpu.parallel.decomp import Decomp2D, block_staggered
    from justrelax_tpu.parallel.stokes2d import solve_ve_sharded

    nx = ny = 32
    geometry = Geometry((nx, ny), (1.0, 1.0))
    eta = np.asarray(solcx.solcx_viscosity(geometry, 1.0e6))
    rho = np.asarray(solcx.solcx_density(geometry))
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1),
        eps_abs=0.0, eps_rel=0.0,
    )
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )

    # DCN-aware mesh: 2 hosts along x, 4 local devices along y
    mesh = multihost.make_multihost_grid_mesh(ndim=2, local_shape=(1, 4))
    assert mesh.devices.shape == (2, 4)
    decomp = Decomp2D.make((nx, ny), (2, 4))

    z = np.zeros((nx, ny))
    blocked_np = {
        "Vx": block_staggered(np.zeros((nx + 1, ny + 2)), decomp, (1, 2)),
        "Vy": block_staggered(np.zeros((nx + 2, ny + 1)), decomp, (2, 1)),
        "P": z, "P0": z, "Q": z, "txx": z, "tyy": z,
        "txy": block_staggered(np.zeros((nx + 1, ny + 1)), decomp, (1, 1)),
        "txx_o": z, "tyy_o": z,
        "txy_o": block_staggered(np.zeros((nx + 1, ny + 1)), decomp, (1, 1)),
        "G": np.full((nx, ny), np.inf),
        "K": np.full((nx, ny), np.inf),
        "rho_gx": z, "rho_gy": rho,
    }
    blocks = {
        k: multihost.blocks_from_global(mesh, np.asarray(v))
        for k, v in blocked_np.items()
    }
    # per-host tile-callback initialization path for η (IGG rank-local alloc)
    nxl, nyl = decomp.ni_local
    blocks["eta"] = multihost.blocks_from_tiles(
        mesh, (nxl, nyl),
        lambda c: eta[c[0] * nxl:(c[0] + 1) * nxl, c[1] * nyl:(c[1] + 1) * nyl],
    )
    blocks["inv_dx"] = 1.0 / geometry.di[0]
    blocks["inv_dy"] = 1.0 / geometry.di[1]

    with mesh:
        res = solve_ve_sharded(
            mesh, decomp, blocks, pt, bc, 0.1, iter_max=1000, nout=250
        )

    fields = {
        "P": multihost.gather_blocked(res.P),
        "Vx": multihost.gather_blocked(res.Vx),
        "Vy": multihost.gather_blocked(res.Vy),
        "txy": multihost.gather_blocked(res.txy),
        "err": np.asarray(res.err),
        "iters": np.asarray(res.iters),
    }
    if pid == 0:
        np.savez(out_path, **fields)
    print(f"[worker {pid}] done err={float(res.err):.3e}", flush=True)


if __name__ == "__main__":
    main()
