"""Solve → checkpoint → restore → solve equals an uninterrupted run, bitwise.

The reference restart workflow (docs/src/man/restart.md + src/IO/JLD2.jl:40-143)
promises that resuming from `checkpoint.jld2` mid-simulation continues the run
exactly. Round-trip of a *static* state was already covered
(tests/test_io.py); this pins the stronger property: a VE Stokes time loop
interrupted after k steps, checkpointed (full-precision npz), reloaded into
fresh containers, and continued produces bit-identical state to never
stopping — i.e. the checkpoint captures ALL cross-timestep solver state
(τ_o memory for the Maxwell element, pressure, velocities).

Also covers f32 solver behavior: the same PT loop in float32 converges to
f32-appropriate residuals and tracks the analytic Maxwell curve.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState, ThermalState
from justrelax_tpu.io.checkpoint import checkpointing, load_checkpoint
from justrelax_tpu.models.elastic_buildup import KYR, analytic_solution
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs, pureshear_bc
from justrelax_tpu.solvers.stokes2d import solve_ve


def _setup(dtype=None):
    ni = (16, 16)
    geometry = Geometry(ni, (100.0e3, 100.0e3))
    stokes = StokesState.make(ni, dtype=dtype)
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, CFL=1.0 / math.sqrt(2.1),
        eps_abs=1.0e-6, eps_rel=1.0e-6,
    )
    dt_f = stokes.P.dtype
    eta0, G, eps_bg = 1.0e21, 10.0e9, 1.0e-14
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.full(ni, eta0, dt_f))
    )
    Gc = jnp.full(ni, G, dt_f)
    Kb = jnp.full(ni, jnp.inf, dt_f)
    rho_g = (jnp.zeros(ni, dt_f), jnp.zeros(ni, dt_f))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True)
    )
    Vx, Vy = pureshear_bc(stokes.V.Vx, stokes.V.Vy, geometry.xvi, eps_bg)
    Vx, Vy = flow_bcs((Vx, Vy), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy))
    return stokes, pt, geometry, bc, rho_g, Gc, Kb, (eta0, G, eps_bg)


def _step(stokes, pt, geometry, bc, rho_g, Gc, Kb):
    stokes, info = solve_ve(
        stokes, pt, geometry, bc, rho_g, Gc, Kb, 0.05 * KYR,
        iter_max=20_000, nout=500,
    )
    return stokes, info


def test_solve_restart_solve_bitwise(tmp_path):
    stokes, pt, geometry, bc, rho_g, Gc, Kb, _ = _setup()

    # uninterrupted: 4 steps
    s_ref = stokes
    for _ in range(4):
        s_ref, _ = _step(s_ref, pt, geometry, bc, rho_g, Gc, Kb)

    # interrupted: 2 steps, checkpoint, reload into FRESH containers, 2 steps
    s_a = stokes
    for _ in range(2):
        s_a, _ = _step(s_a, pt, geometry, bc, rho_g, Gc, Kb)
    thermal = ThermalState.make((16, 16))
    path = checkpointing(str(tmp_path), s_a, thermal, time=2 * 0.05 * KYR, timestep=0.05 * KYR)

    s_b, _, t_loaded, dt_loaded = load_checkpoint(
        path, StokesState.make((16, 16)), ThermalState.make((16, 16))
    )
    assert t_loaded == 2 * 0.05 * KYR and dt_loaded == 0.05 * KYR
    for _ in range(2):
        s_b, _ = _step(s_b, pt, geometry, bc, rho_g, Gc, Kb)

    import jax
    ref_leaves = jax.tree_util.tree_leaves_with_path(s_ref)
    got_leaves = jax.tree_util.tree_leaves_with_path(s_b)
    assert len(ref_leaves) == len(got_leaves)
    for (kp_r, leaf_r), (kp_g, leaf_g) in zip(ref_leaves, got_leaves):
        assert kp_r == kp_g
        np.testing.assert_array_equal(
            np.asarray(leaf_r), np.asarray(leaf_g),
            err_msg=f"restart mismatch at {jax.tree_util.keystr(kp_r)}",
        )


def test_f32_ve_solver_behavior():
    """float32 end-to-end: converges below the f32-appropriate residual and
    matches the analytic Maxwell curve to <1%% after 5 steps."""
    stokes, pt, geometry, bc, rho_g, Gc, Kb, (eta0, G, eps_bg) = _setup(
        dtype=jnp.float32
    )
    assert stokes.P.dtype == jnp.float32
    pt = pt.replace(eps_abs=jnp.asarray(1.0e-5, jnp.float32),
                    eps_rel=jnp.asarray(1.0e-5, jnp.float32))
    t = 0.0
    for _ in range(5):
        stokes, info = _step(stokes, pt, geometry, bc, rho_g, Gc, Kb)
        t += 0.05 * KYR
    assert stokes.tau.yy.dtype == jnp.float32
    assert np.isfinite(float(info.err))
    # measured f32 residual floor for this config is ~2.3e-4 (the normalized
    # PT residual stalls there; float64 reaches 1e-6) — pin that behavior
    assert float(info.err) < 5.0e-4
    got = float(jnp.abs(stokes.tau.yy).max())
    want = analytic_solution(eps_bg, t, G, eta0)
    assert abs(got - want) / want < 1.0e-2
