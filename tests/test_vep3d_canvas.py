"""Collocated-canvas 3D VEP iteration == the solver's serial op composition.

The canvas path (ops/stokes3d_vep_canvas.py) re-drives the exact
update_stresses_center_edges_3d body through canvas-collocated StaggeredMoves;
its oracle is the slice/pad composition used by solvers/stokes3d_vep.py
one_iteration (maxloc → compute_P → ρ(T,P)g → strain rate → fused
center+edges return mapping → τII viscosity continuation → compute_V_3d +
free-slip BCs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.ops import stokes3d as k3
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.ops.stencil import maxloc
from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.ops.stokes3d_vep import (
    _inv_II,
    update_stresses_center_edges_3d,
)
from justrelax_tpu.ops.stokes3d_vep_canvas import (
    iteration_vep3d_canvas,
    pack_vep_carry,
    unpack_vep_carry,
    vep3d_canvas_consts,
    vep3d_chunk_canvas,
)
from justrelax_tpu.rheology.materials import (
    Material,
    MaterialStack,
    compute_density,
    get_bulk_modulus,
    get_shear_modulus,
    phase_average,
    _as_stack,
)
from justrelax_tpu.rheology.phases import phase_ratios_from_field
from justrelax_tpu.rheology.viscosity import (
    continuation_linear,
    phase_viscosity,
)

REL_LAM = 0.2
VISC_REL = 1.0e-2


def _setup(ni, seed=0, rho0=0.0):
    nx, ny, nz = ni
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.75 / math.sqrt(3.1))
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=rho0, Kb=4.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=0.0, eta_reg=1.25e-2,
                  gravity=-9.81 if rho0 else 0.0)
    material = MaterialStack.make([
        Material(G=1.0, eta0=1.0, **common),
        Material(G=0.5, eta0=0.1, **common),
    ])
    rng = np.random.default_rng(seed)
    inside = rng.random(ni) < 0.2
    pr = phase_ratios_from_field(jnp.asarray(inside.astype(int)), 2)
    pr_e = (pr.edge_yz, pr.edge_xz, pr.edge_xy)

    def r(*shape):
        return jnp.asarray(rng.standard_normal(shape))

    Vx = r(nx + 1, ny + 2, nz + 2) * 0.1
    Vy = r(nx + 2, ny + 1, nz + 2) * 0.1
    Vz = r(nx + 2, ny + 2, nz + 1) * 0.1
    Z = jnp.zeros(ni)
    state = dict(
        V=(Vx, Vy, Vz), P=r(*ni) * 0.1, theta=r(*ni) * 0.1,
        tau_c=tuple(r(*ni) * 0.1 for _ in range(6)),
        tau_e=(r(nx, ny + 1, nz + 1) * 0.1, r(nx + 1, ny, nz + 1) * 0.1,
               r(nx + 1, ny + 1, nz) * 0.1),
        eta=jnp.exp(0.3 * r(*ni)),
        lam=jnp.abs(r(*ni)) * 0.01,
        lam_e=(jnp.abs(r(nx, ny + 1, nz + 1)) * 0.01,
               jnp.abs(r(nx + 1, ny, nz + 1)) * 0.01,
               jnp.abs(r(nx + 1, ny + 1, nz)) * 0.01),
    )
    # elastic memory near yield so both yield branches are active
    consts = dict(
        tau_o_c6=(jnp.full(ni, 1.0), jnp.full(ni, -1.0), Z, Z, Z, Z),
        tau_o_e3=tuple(jnp.zeros_like(t) for t in state["tau_e"]),
        EII=jnp.abs(r(*ni)) * 0.1,
        P0=r(*ni) * 0.1,
        Q=Z,
        pr=pr, pr_e=pr_e,
        T=None,
    )
    return geometry, pt, material, state, consts


def _serial_iteration(state, consts, material, geometry, pt, dt):
    """solvers/stokes3d_vep.py::one_iteration, inlined (serial moves)."""
    inv_di = tuple(1.0 / d for d in geometry.di)
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True))
    pr_c, pr_e = consts["pr"].center, consts["pr_e"]
    K_c = get_bulk_modulus(material, pr_c)
    G_c = get_shear_modulus(material, pr_c)
    Vx, Vy, Vz = state["V"]
    eta_tau = maxloc(state["eta"], window=1)
    grad_V = k3.compute_grad_V_3d(Vx, Vy, Vz, inv_di)
    _, theta = compute_P(
        state["theta"], consts["P0"], grad_V, consts["Q"], eta_tau,
        K_c, G_c, dt, pt.r, pt.theta_dtau,
    )
    rho = compute_density(material, T=consts["T"], P=state["P"],
                          phase_ratios=pr_c)
    g = phase_average(_as_stack(material).params.gravity, pr_c)
    z = jnp.zeros_like(rho)
    fx, fy, fz = z, z, rho * jnp.broadcast_to(g, rho.shape)
    eps = k3.compute_strain_rate_3d(grad_V, Vx, Vy, Vz, inv_di)
    res = update_stresses_center_edges_3d(
        eps[:3], eps[3:], state["tau_c"], state["tau_e"],
        consts["tau_o_c6"], consts["tau_o_e3"],
        theta, state["eta"], state["lam"], state["lam_e"], consts["EII"],
        material, pr_c, pr_e, REL_LAM, dt, pt.theta_dtau,
    )
    eps0 = jnp.where(
        sum(jnp.abs(t) for t in res.tau_c) == 0,
        jnp.finfo(state["P"].dtype).eps, 0.0)
    tII = _inv_II((res.tau_c[0] + eps0,) + res.tau_c[1:])
    eta_n = phase_viscosity(material, tII, consts["T"], pr_c, "tau")
    eta = continuation_linear(eta_n, state["eta"], VISC_REL)
    tau6 = res.tau_c[:3] + res.tau_e
    Vx, Vy, Vz, _, _, _ = k3.compute_V_3d(
        Vx, Vy, Vz, res.P_corrected, tau6, fx, fy, fz, eta_tau,
        pt.etadtau, inv_di,
    )
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    return dict(
        V=(Vx, Vy, Vz), P=res.P_corrected, theta=theta,
        tau_c=res.tau_c, tau_e=res.tau_e, eta=eta,
        lam=res.lam, lam_e=res.lam_e,
    )


_KEYS = ("V", "P", "theta", "tau_c", "tau_e", "eta", "lam", "lam_e")


def _pack(state):
    return pack_vep_carry(*(state[k] for k in _KEYS))


def _unpack(c):
    return dict(zip(_KEYS, unpack_vep_carry(c)))


def _assert_state_close(want, got, atol):
    for key in want:
        ws = want[key] if isinstance(want[key], tuple) else (want[key],)
        gs = got[key] if isinstance(got[key], tuple) else (got[key],)
        for i, (a, b) in enumerate(zip(ws, gs)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                err_msg=f"canvas VEP mismatch in {key}[{i}]",
            )


@pytest.mark.parametrize("ni,rho0", [((12, 12, 12), 0.0),
                                     ((9, 12, 10), 2.0)])
def test_vep3d_canvas_matches_serial(ni, rho0):
    geometry, pt, material, state, consts = _setup(ni, seed=1, rho0=rho0)
    dt = jnp.asarray(0.125)
    inv_di = tuple(1.0 / d for d in geometry.di)

    want = state
    for _ in range(4):
        want = _serial_iteration(want, consts, material, geometry, pt, dt)

    co = vep3d_canvas_consts(
        material, consts["tau_o_c6"], consts["tau_o_e3"], consts["EII"],
        consts["P0"], consts["Q"], consts["pr"].center, consts["pr_e"],
        T=consts["T"],
    )
    got_c = vep3d_chunk_canvas(
        _pack(state), co, material, inv_di, 4,
        dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
        lambda_relaxation=REL_LAM, viscosity_relaxation=VISC_REL,
    )
    _assert_state_close(want, _unpack(got_c), atol=5e-13)


def test_vep3d_canvas_yield_branch_active():
    """The parity config must actually exercise the plastic branch."""
    geometry, pt, material, state, consts = _setup((12, 12, 12), seed=1)
    dt = jnp.asarray(0.125)
    out = _serial_iteration(state, consts, material, geometry, pt, dt)
    assert float(jnp.max(out["lam"])) > 0.0
    assert any(float(jnp.max(l)) > 0.0 for l in out["lam_e"])


def test_vep3d_canvas_shift_slice_bitwise_equal_roll():
    """The pad+slice shift lowering == roll lowering, bitwise, through the
    full VEP canvas iteration (wrap-sourced slots are never consumed)."""
    ni = (9, 12, 10)
    geometry, pt, material, state, consts = _setup(ni, seed=7, rho0=2.0)
    dt = jnp.asarray(0.125)
    inv_di = tuple(1.0 / d for d in geometry.di)
    co = vep3d_canvas_consts(
        material, consts["tau_o_c6"], consts["tau_o_e3"], consts["EII"],
        consts["P0"], consts["Q"], consts["pr"].center, consts["pr_e"],
    )
    outs = {}
    for mode in ("roll", "slice"):
        outs[mode] = _unpack(vep3d_chunk_canvas(
            _pack(state), co, material, inv_di, 4,
            dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
            lambda_relaxation=REL_LAM, viscosity_relaxation=VISC_REL,
            shift=mode,
        ))
    _assert_state_close(outs["roll"], outs["slice"], atol=0.0)


def test_solve_vep_3d_use_pallas_matches_xla():
    """The collocated-canvas chunk, called directly, reproduces one
    ``solve_vep_3d`` chunk of exactly 100 XLA iterations at roundoff on a
    two-phase plastic shear config."""
    from justrelax_tpu.core.state import StokesState
    from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d

    n = 10
    ni = (n, n, n)
    geometry = Geometry(ni, (1.0, 1.0, 1.0))
    # cohesion low enough that the single-solve VE trial stress
    # (tau ~ 2*eta_ve*eII ~ 0.4 at dt=0.25, G=1) exceeds yield
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0,
                  C=0.15 / math.cos(math.radians(30.0)), friction_angle=30.0,
                  eta_reg=8.0e-3)
    mat = MaterialStack.make([
        Material(G=1.0, **common), Material(G=0.5, **common)
    ])
    X, Y, Z = geometry.cell_centers_mesh()
    sph = (
        (np.asarray(X) - 0.5) ** 2 + (np.asarray(Y) - 0.5) ** 2
        + (np.asarray(Z) - 0.5) ** 2
    ) < 0.15**2
    pr = phase_ratios_from_field(jnp.asarray(sph.astype(int)), 2)
    pr_e = (pr.edge_yz, pr.edge_xz, pr.edge_xy)
    stokes = StokesState.make(ni)
    stokes = stokes.replace(
        viscosity=stokes.viscosity.replace(eta=jnp.ones(ni)))
    xv = jnp.asarray(geometry.xvi[0])
    zv = jnp.asarray(geometry.xvi[2])
    Vx = jnp.broadcast_to(xv[:, None, None], (n + 1, n + 2, n + 2))
    Vy = jnp.zeros((n + 2, n + 1, n + 2))
    Vz = jnp.broadcast_to((-zv)[None, None, :], (n + 2, n + 2, n + 1))
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True,
                        front=True, back=True))
    Vx, Vy, Vz = flow_bcs((Vx, Vy, Vz), bc)
    stokes = stokes.replace(V=stokes.V.replace(Vx=Vx, Vy=Vy, Vz=Vz))
    pt = PTStokesCoeffs.make(
        geometry.li, geometry.di, eps_rel=1.0e-6, eps_abs=1.0e-6,
        CFL=0.75 / math.sqrt(3.1))
    dt = 0.25
    out_x, info_x = solve_vep_3d(
        stokes, pt, geometry, bc, mat, pr.center, pr_e, dt,
        iter_max=100, iter_min=100, nout=100)
    assert int(info_x.iters) == 100

    t, to = stokes.tau, stokes.tau_o
    co = vep3d_canvas_consts(
        mat, (to.xx, to.yy, to.zz, to.yz_c, to.xz_c, to.xy_c),
        (to.yz, to.xz, to.xy), stokes.EII_pl, stokes.P, stokes.Q,
        pr.center, pr_e,
    )
    zeros_e = tuple(jnp.zeros_like(e) for e in (t.yz, t.xz, t.xy))
    carry = pack_vep_carry(
        (Vx, Vy, Vz), stokes.P, stokes.P,
        (t.xx, t.yy, t.zz, t.yz_c, t.xz_c, t.xy_c), (t.yz, t.xz, t.xy),
        stokes.viscosity.eta, jnp.zeros(ni), zeros_e,
    )
    inv_di = tuple(1.0 / d for d in geometry.di)
    got = _unpack(vep3d_chunk_canvas(
        carry, co, mat, inv_di, 100,
        dt=dt, r=pt.r, theta_dtau=pt.theta_dtau, etadtau=pt.etadtau,
        lambda_relaxation=REL_LAM, viscosity_relaxation=VISC_REL,
    ))
    scale = float(jnp.abs(out_x.tau.II).max())
    tx = out_x.tau
    want = dict(
        V=(out_x.V.Vx, out_x.V.Vy, out_x.V.Vz), P=out_x.P,
        tau_c=(tx.xx, tx.yy, tx.zz), tau_e=(tx.yz, tx.xz, tx.xy),
        eta=out_x.viscosity.eta,
    )
    got["tau_c"] = got["tau_c"][:3]
    _assert_state_close(want, {k: got[k] for k in want}, atol=1e-8 * scale)
    assert float(jnp.max(out_x.EII_pl)) > 0.0  # plasticity active
