"""Collocated-canvas 3D iteration (XLA roll+mask) == serial op composition.

The canvas formulation (ops/stokes3d_canvas.py) is a fusion-layout
alternative; its correctness oracle is the production slice/pad kernel chain
(`_serial_iteration` below).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.ops import stokes3d as k3
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stencil import maxloc
from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.ops.stokes3d_canvas import (
    iteration3d_canvas,
    pack_carry,
    stokes3d_chunk_canvas,
    unpack_carry,
    ve3d_canvas_coefficients,
)
NAMES = ("Vx", "Vy", "Vz", "P", "txx", "tyy", "tzz", "tyz", "txz", "txy")


def _random_state(ni, seed=0):
    nx, ny, nz = ni
    rng = np.random.default_rng(seed)

    def r(*shape):
        return jnp.asarray(rng.standard_normal(shape))

    Vx = r(nx + 1, ny + 2, nz + 2)
    Vy = r(nx + 2, ny + 1, nz + 2)
    Vz = r(nx + 2, ny + 2, nz + 1)
    P = r(nx, ny, nz)
    txx, tyy, tzz = r(nx, ny, nz), r(nx, ny, nz), r(nx, ny, nz)
    tyz = r(nx, ny + 1, nz + 1)
    txz = r(nx + 1, ny, nz + 1)
    txy = r(nx + 1, ny + 1, nz)
    eta = jnp.exp(0.5 * r(nx, ny, nz))
    fx, fy, fz = r(nx, ny, nz), r(nx, ny, nz), r(nx, ny, nz)
    return (Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy), (eta, fx, fy, fz)


def _serial_iteration(fields, consts, geometry, pt):
    """One viscous-limit PT iteration via the production slice/pad kernels."""
    Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy = fields
    eta, fx, fy, fz = consts
    inv_di = tuple(1.0 / d for d in geometry.di)
    eta_tau = maxloc(eta, window=1)
    Z = jnp.zeros_like(P)
    G = jnp.full_like(P, jnp.inf)
    K = jnp.full_like(P, jnp.inf)
    dt = jnp.asarray(jnp.inf)
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )
    grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
    _, P = compute_P(P, Z, grad_V, Z, eta_tau, K, G, dt, pt.r, pt.theta_dtau)
    eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
    tau = k3.compute_tau_ve_3d(
        (txx, tyy, tzz, tyz, txz, txy),
        (Z, Z, Z, jnp.zeros_like(tyz), jnp.zeros_like(txz),
         jnp.zeros_like(txy)),
        eps, eta, G, pt.theta_dtau, dt,
    )
    Vx, Vy, Vz, *_ = k3.compute_V_3d(
        Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, pt.etadtau, inv_di
    )
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    txx, tyy, tzz, tyz, txz, txy = tau
    return Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy


@pytest.mark.parametrize("ni", [(14, 10, 12), (22, 9, 7)])
def test_canvas_matches_serial_viscous(ni):
    geometry = Geometry(ni, (1.0, 1.3, 0.8))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.9 / math.sqrt(3.1))
    fields, (eta, fx, fy, fz) = _random_state(ni)
    eta_tau = maxloc(eta, window=1)
    inv_di = tuple(1.0 / d for d in geometry.di)

    want = fields
    for _ in range(4):
        want = _serial_iteration(want, (eta, fx, fy, fz), geometry, pt)

    co = ve3d_canvas_coefficients(
        eta, eta_tau, float(pt.r), float(pt.theta_dtau), float(pt.etadtau),
        fx=fx, fy=fy, fz=fz,
    )
    carry = tuple(pack_carry(*fields))
    got = unpack_carry(
        jnp.stack(stokes3d_chunk_canvas(carry, co, inv_di, 4)), *ni
    )
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=2e-12,
            err_msg=f"canvas mismatch in {name}",
        )


def test_canvas_matches_serial_ve_compressible():
    """Full VE/compressible coefficient path: finite G and K, elastic
    memory tau_o on every component, P0/Q sources, finite dt."""
    ni = (14, 10, 12)
    nx, ny, nz = ni
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di, CFL=0.9 / math.sqrt(3.1))
    fields, (eta, fx, fy, fz) = _random_state(ni, seed=5)
    eta_tau = maxloc(eta, window=1)
    inv_di = tuple(1.0 / d for d in geometry.di)
    rng = np.random.default_rng(7)

    def r(*shape):
        return jnp.asarray(rng.standard_normal(shape)) * 0.1

    G = jnp.exp(r(*ni) + 1.0)
    K = jnp.exp(r(*ni) + 2.0)
    P0, Q = r(*ni), r(*ni)
    tau_o = (r(*ni), r(*ni), r(*ni),
             r(nx, ny + 1, nz + 1), r(nx + 1, ny, nz + 1),
             r(nx + 1, ny + 1, nz))
    dt = 0.5
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True)
    )

    def serial(fields):
        Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy = fields
        grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
        _, P = compute_P(P, P0, grad_V, Q, eta_tau, K, G, dt,
                         pt.r, pt.theta_dtau)
        eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
        tau = k3.compute_tau_ve_3d(
            (txx, tyy, tzz, tyz, txz, txy), tau_o, eps, eta, G,
            pt.theta_dtau, dt,
        )
        Vx, Vy, Vz, *_ = k3.compute_V_3d(
            Vx, Vy, Vz, P, tau, fx, fy, fz, eta_tau, pt.etadtau, inv_di
        )
        Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
        return (Vx, Vy, Vz, P) + tau

    want = fields
    for _ in range(3):
        want = serial(want)

    co = ve3d_canvas_coefficients(
        eta, eta_tau, float(pt.r), float(pt.theta_dtau), float(pt.etadtau),
        fx=fx, fy=fy, fz=fz, G=G, K=K, P0=P0, Q=Q, tau_o=tau_o, dt=dt,
    )
    carry = tuple(pack_carry(*fields))
    for _ in range(3):
        carry = iteration3d_canvas(carry, co, inv_di, nx=nx, ny=ny, nz=nz)
    got = unpack_carry(jnp.stack(carry), *ni)
    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=2e-12,
            err_msg=f"canvas VE mismatch in {name}",
        )


def test_lean_consts_bitwise_equal_precomputed():
    """The lean-consts chunk (η/ητ/f streamed, coefficients re-derived
    inside the loop body behind the anti-LICM carry scalar) is BITWISE
    equal to the precomputed-coefficient chunk — the in-body derivation
    mirrors ve3d_canvas_coefficients' scalar algebra exactly and the unit
    scalar multiplies are exact."""
    from justrelax_tpu.ops.stokes3d_canvas import (
        lean_canvas_consts,
        stokes3d_chunk_canvas_lean,
    )

    ni = (14, 10, 12)
    geometry = Geometry(ni, (1.0, 1.3, 0.8))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.9 / math.sqrt(3.1))
    r, theta_dtau, etadtau = (
        float(pt.r), float(pt.theta_dtau), float(pt.etadtau))
    fields, (eta, fx, fy, fz) = _random_state(ni, seed=3)
    eta_tau = maxloc(eta, window=1)
    inv_di = tuple(1.0 / d for d in geometry.di)
    carry = tuple(pack_carry(*fields))

    co = ve3d_canvas_coefficients(
        eta, eta_tau, r, theta_dtau, etadtau,
        fx=jnp.zeros_like(fz), fy=jnp.zeros_like(fz), fz=fz,
    )
    want = stokes3d_chunk_canvas(carry, co, inv_di, 5)

    lc = lean_canvas_consts(eta, eta_tau, fz=fz)
    got = stokes3d_chunk_canvas_lean(
        carry, lc, r, theta_dtau, etadtau, inv_di, 5)

    for name, a, b in zip(NAMES, want, got):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"lean-consts mismatch in {name}",
        )


def test_shift_impl_slice_bitwise_equal_roll():
    """pad+slice neighbor shifts == roll shifts, bitwise: wrap-sourced
    slots are never consumed (every shifted read sits inside a masked
    where), so the lowering choice cannot change results."""
    ni = (14, 10, 12)
    geometry = Geometry(ni, (1.0, 1.3, 0.8))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.9 / math.sqrt(3.1))
    fields, (eta, fx, fy, fz) = _random_state(ni, seed=11)
    eta_tau = maxloc(eta, window=1)
    inv_di = tuple(1.0 / d for d in geometry.di)
    carry = tuple(pack_carry(*fields))

    co = ve3d_canvas_coefficients(
        eta, eta_tau, float(pt.r), float(pt.theta_dtau),
        float(pt.etadtau), fx=fx, fy=fy, fz=fz,
    )
    outs = {
        mode: stokes3d_chunk_canvas(carry, co, inv_di, 5, shift=mode)
        for mode in ("roll", "slice")
    }

    for name, a, b in zip(NAMES, outs["roll"], outs["slice"]):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"shift-impl mismatch in {name}",
        )


def test_solver_lean_auto_dispatch_matches():
    """The lean-consts and precomputed-coefficient canvas chunks, called
    directly with the solver's pressure convention (ψ from η), reproduce
    one ``solve_ve_3d`` chunk of exactly 100 XLA iterations at roundoff."""
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.ops.stokes3d_canvas import (
        lean_canvas_consts,
        stokes3d_chunk_canvas_lean,
    )
    from justrelax_tpu.solvers.stokes3d import solve_ve_3d

    ni = (16, 16, 16)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.9 / math.sqrt(3.1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True))
    rng = np.random.default_rng(0)
    eta = jnp.asarray(np.exp(0.3 * rng.normal(size=ni)))
    fz = jnp.asarray(rng.normal(size=ni))
    Z = jnp.zeros(ni)
    st = StokesState.make(ni)
    st = st.replace(viscosity=st.viscosity.replace(eta=eta))
    G = jnp.full(ni, jnp.inf)
    K = jnp.full(ni, jnp.inf)
    out_xla, info = solve_ve_3d(st, pt, geometry, bc, (Z, Z, fz), G, K,
                                jnp.inf, iter_max=100, nout=100)
    assert int(info.iters) == 100

    r, theta_dtau, etadtau = (
        float(pt.r), float(pt.theta_dtau), float(pt.etadtau))
    inv_di = tuple(1.0 / d for d in geometry.di)
    eta_tau = maxloc(eta, window=1)
    t = st.tau
    carry = tuple(pack_carry(st.V.Vx, st.V.Vy, st.V.Vz, st.P,
                             t.xx, t.yy, t.zz, t.yz, t.xz, t.xy))
    co = ve3d_canvas_coefficients(eta, eta_tau, r, theta_dtau, etadtau,
                                  fx=Z, fy=Z, fz=fz, psi_eta=eta)
    out_pre = unpack_carry(
        jnp.stack(stokes3d_chunk_canvas(carry, co, inv_di, 100)), *ni)
    lc = lean_canvas_consts(eta, eta_tau, fz=fz)
    out_lean = unpack_carry(jnp.stack(stokes3d_chunk_canvas_lean(
        carry, lc, r, theta_dtau, etadtau, inv_di, 100,
        psi_from_eta=True)), *ni)
    assert float(jnp.abs(out_lean[2] - out_pre[2]).max()) < 1e-14
    assert float(jnp.abs(out_lean[2] - out_xla.V.Vz).max()) < 1e-12
    assert float(jnp.abs(out_lean[3] - out_xla.P).max()) < 1e-12
