"""Regenerate the frozen CPU/f64 physics oracles of the golden solves
(justrelax_tpu/utils/goldens.py) that the reference has no oracle for.

Run on CPU:  JAX_PLATFORMS=cpu python scripts/make_f64_goldens.py
The printed values are frozen into utils/goldens.py, where f64 runs are held
to them at 1e-4 relative and f32 runs at 2e-2 relative.
"""
import math
import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, ".")


def blankenbach():
    from justrelax_tpu.models import blankenbach as m
    ur, nu, info, _, _ = m.run(nx=32, ny=32, nit=1)
    print("blankenbach ur[-1] f64:", float(ur[-1]))


def blob3d():
    from justrelax_tpu.models import rising_blob3d as m
    s_x, _, _, _, zc = m.run(n=16, nt=1)
    print("blob3d zc f64:", float(zc[0]),
          "vzmax:", float(np.abs(np.asarray(s_x.V.Vz)).max()))


def vep3d():
    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops.bc import (
        Faces, VelocityBoundaryConditions, flow_bcs)
    from justrelax_tpu.rheology.materials import Material, MaterialStack
    from justrelax_tpu.rheology.phases import phase_ratios_from_field
    from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d

    n = 10
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0,
                  C=0.15 / math.cos(math.radians(30.0)),
                  friction_angle=30.0, eta_reg=8.0e-3)
    mat = MaterialStack.make([
        Material(G=1.0, **common), Material(G=0.5, **common)])
    X, Y, Z = geometry.cell_centers_mesh()
    sph = ((np.asarray(X) - 0.5) ** 2 + (np.asarray(Y) - 0.5) ** 2
           + (np.asarray(Z) - 0.5) ** 2) < 0.15 ** 2
    pr = phase_ratios_from_field(jnp.asarray(sph.astype(int)), 2)
    st = StokesState.make(ni)
    st = st.replace(viscosity=st.viscosity.replace(eta=jnp.ones(ni)))
    xv = jnp.asarray(geometry.xvi[0])
    zv = jnp.asarray(geometry.xvi[2])
    Vx = jnp.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2))
    Vy = jnp.zeros((n + 2, n + 1, n + 2))
    Vz = jnp.broadcast_to((-zv)[None, None, :], (n + 2, n + 2, n + 1))
    bc = VelocityBoundaryConditions(free_slip=Faces(
        left=True, right=True, top=True, bot=True, front=True, back=True))
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, eps_rel=1.0e-5,
                             eps_abs=1.0e-5, CFL=0.75 / math.sqrt(3.1))
    out_x, info_x = solve_vep_3d(
        st, pt, geometry, bc, mat, pr.center,
        (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.25,
        iter_max=3000, iter_min=100, nout=100)
    print("vep3d tauII max f64:", float(jnp.abs(out_x.tau.II).max()),
          "err:", float(info_x.err))


if __name__ == "__main__":
    blankenbach()
    blob3d()
    vep3d()
