"""Golden-value solves: small end-to-end runs checked against oracles.

One module serves every place that checks the physics on a device: the CPU
tests, ``bench.py`` and ``chip_smoke.py`` run the same thunks. Each golden
runs in ``float64`` or ``float32``. The precision is set for the whole solve
with ``jax.enable_x64``, so every array a model builds takes it.

Oracles and tolerances:

- ``float64`` is held to the reference's own tolerances (BASELINE.md; the
  shear band as tests/test_shearband2d.py), or to a value frozen from a
  CPU/f64 run of the same configuration (``scripts/make_f64_goldens.py``)
  where the reference has no oracle for that configuration.
- ``float32`` is held to the same oracles at tolerances that f32 can meet;
  each limit carries its reason.

Reference oracles: test_stokes_solcx.jl:33-34, test_diffusion2D.jl:133-134,
test_shearband2D.jl:197-201, test_stokes_burstedde.jl:32-40,
test_shearband2D_DYREL.jl, test_Blankenbach.jl:285-287.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import jax
import numpy as np

__all__ = ["GOLDENS", "DTYPES", "run_golden"]

DTYPES = ("float64", "float32")

# A converged solve stops at the first chunk whose residual is under the
# tolerance. Another device sums in another order, which can move that
# chunk by one; the answer then moves by about the solve tolerance. A frozen
# CPU/f64 value is therefore held to 1e-4 relative in f64, well above that
# and far below any physics change.
F64_FROZEN_RTOL = 1.0e-4
F64_FROZEN_WHY = "frozen CPU/f64 value; stopping chunk may move by one"
# f32 keeps ~7 digits and its PT residual stalls near 1e-6 relative, so a
# frozen f64 value is met to 2e-2 relative in f32.
F32_FROZEN_RTOL = 2.0e-2
F32_FROZEN_WHY = "f32 PT residual floor ~1e-6 relative"


def _check(name, value, limit, ok, why, **extra):
    return dict(name=name, value=float(value), limit=limit, ok=bool(ok),
                why=why, **extra)


def _below(name, value, limit, why):
    return _check(name, value, limit, np.isfinite(value) and value < limit,
                  why)


def _near(name, value, golden, atol, why):
    return _check(name, value, atol,
                  np.isfinite(value) and abs(value - golden) <= atol, why,
                  golden=golden, kind="abs")


def _rel(name, value, golden, rtol, why):
    ok = np.isfinite(value) and abs(value - golden) <= rtol * abs(golden)
    return _check(name, value, rtol, ok, why, golden=golden, kind="rel")


def _frozen(name, value, golden, f64):
    if f64:
        return _rel(name, value, golden, F64_FROZEN_RTOL, F64_FROZEN_WHY)
    return _rel(name, value, golden, F32_FROZEN_RTOL, F32_FROZEN_WHY)


def solcx(f64):
    from justrelax_tpu.models import solcx as m

    _, _, info, _ = m.run(nx=32, ny=32, d_eta=1.0e6)
    if f64:
        return [_below("err", float(info.err), 1.0e-8, "reference oracle")]
    return [_below("err", float(info.err), 5.0e-6,
                   "f32 PT residual stalls at its rounding floor ~1e-6")]


def diffusion2d(f64):
    from justrelax_tpu.models import diffusion2d as m

    thermal, info = m.run(nx=32, ny=32)
    T = np.asarray(thermal.T)
    mid = float(T[T.shape[0] // 2, T.shape[1] // 2])
    golden = 1817.9448461176817
    if f64:
        return [_near("T_mid", mid, golden, 0.1, "reference oracle"),
                _below("err", float(info.err), 1.0e-8, "reference oracle")]
    return [_near("T_mid", mid, golden, 0.5,
                  "f32 rounding of ~2e3 K over 20 implicit steps")]


def shearband(f64):
    from justrelax_tpu.models import shearband as m

    _, info, tau_max, sol, tau_II = m.run(n=32, nt=10)
    v = float(np.asarray(tau_II).max())
    err = float(info.err)
    if f64:
        why = "reference value, tolerance as tests/test_shearband2d.py"
        return [
            _below("err", err, 1.0e-6, "reference oracle"),
            _near("sol_end", float(sol[-1]), 1.8358, 1.0e-4,
                  "reference oracle (analytic VE buildup)"),
            _near("tauII_max", v, 1.6448491195234836, 5.0e-3, why),
            _near("tauII_end", float(tau_max[-1]), 1.6392450041641278,
                  5.0e-3, why),
            _below("tauII_max_vs_2tau_y", v, 2.0 * 1.6,
                   "stress stays below twice the yield stress"),
        ]
    return [
        _near("tauII_max", v, 1.6415, 0.01,
              "f32 solve of the f64 value 1.6415 at its residual floor"),
        _below("err", err, 1.0e-4, "f32 PT residual floor"),
    ]


def burstedde(f64):
    from justrelax_tpu.models import burstedde as m

    if f64:
        geom, st, info = m.run(nx=16, ny=16, nz=16, iter_max=60_000,
                               nout=1_000)
    else:
        geom, st, info = m.run(nx=16, ny=16, nz=16, iter_max=20_000,
                               nout=1_000)
    vx_a, _ = m.analytic_velocity(geom)
    vx = np.asarray(st.V.Vx[:, 1:-1, 8])
    rel = float(np.linalg.norm(vx - vx_a) / np.linalg.norm(vx_a))
    if f64:
        return [_below("err", float(info.err), 1.0e-8, "reference oracle"),
                _below("vx_rel_err", rel, 2.0e-2,
                       "discretization error at 16^3 "
                       "(tests/test_stokes_burstedde.py)")]
    return [_below("vx_rel_err", rel, 5.0e-2,
                   "discretization error at 16^3 plus the f32 residual "
                   "floor")]


def dyrel(f64):
    from justrelax_tpu.models import shearband_dyrel as m

    _, info, _, sol, tau_II = m.run(n=32, nt=10)
    v = float(np.asarray(tau_II).max())
    if f64:
        return [_below("err", float(info.err), 1.0e-6, "reference oracle"),
                _near("tauII_max", v, 1.639, 1.0e-3,
                      "reference value (tests/test_dyrel.py)")]
    return [_near("tauII_max", v, 1.639, 0.02,
                  "f32 solve of the f64 value at its residual floor")]


def blankenbach(f64):
    """One coupled step (Stokes with ρ(T)·g, PT thermal, WENO-5 advection)
    against the frozen CPU/f64 Urms of this configuration."""
    from justrelax_tpu.models import blankenbach as m

    ur, _, info, _, _ = m.run(nx=32, ny=32, nit=1)
    golden = 0.29207194481326537
    return [_frozen("Urms", float(ur[-1]), golden, f64)]


def vep3d(f64):
    """The 3D two-phase VEP shear case through ``solve_vep_3d``."""
    import jax.numpy as jnp

    from justrelax_tpu.core.coeffs import PTStokesCoeffs
    from justrelax_tpu.core.grid import Geometry
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops.bc import (
        Faces,
        VelocityBoundaryConditions,
        flow_bcs,
    )
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
    out, _ = solve_vep_3d(
        st, pt, geometry, bc, mat, pr.center,
        (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.25,
        iter_max=3000, iter_min=100, nout=100)
    v = float(jnp.abs(out.tau.II).max())
    return [_frozen("tauII_max", v, 0.16069082924126105, f64)]


def rising_blob3d(f64):
    """One coupled 3D step: VE Stokes with particle phase ratios, RK2
    particle advection, move and inject."""
    from justrelax_tpu.models import rising_blob3d as m

    st, _, _, _, _ = m.run(n=16, nt=1)
    v = float(np.abs(np.asarray(st.V.Vz)).max())
    return [_frozen("Vz_max", v, 3.2058708898361283e-09, f64)]


GOLDENS: Dict[str, Callable[[bool], List[dict]]] = {
    "solcx": solcx,
    "diffusion2d": diffusion2d,
    "shearband": shearband,
    "burstedde": burstedde,
    "dyrel": dyrel,
    "blankenbach": blankenbach,
    "vep3d": vep3d,
    "rising_blob3d": rising_blob3d,
}


def run_golden(name: str, dtype: str) -> dict:
    """Run golden ``name`` in ``dtype`` ("float64" or "float32") on the
    default device. Returns ``{"pass": bool, "checks": [...]}``."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    f64 = dtype == "float64"
    with jax.enable_x64(f64):
        checks = GOLDENS[name](f64)
    return {"pass": all(c["ok"] for c in checks), "checks": checks}
