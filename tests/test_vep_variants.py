"""Physics variants of the 2D and 3D VEP iteration on the plain XLA path:
compressibility with dilatancy, no-slip walls, ρ(T) buoyancy, power-law
creep with a temperature field, the Drucker-Prager tension cap, and the
split of the 3D return mapping into its center and edge passes.

Each runs a fixed number of PT iterations at a small size and is checked
against an invariant of the physics and against values frozen from a CPU/f64
run of the same configuration (rtol 1e-9: the same program on the same
backend; only a change of the arithmetic moves them)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.core.grid import Geometry
from justrelax_tpu.core.state import StokesState
from justrelax_tpu.models.shearband import _circle_phase_ratios
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions, flow_bcs
from justrelax_tpu.rheology.materials import Material, MaterialStack
from justrelax_tpu.solvers.stokes2d_vep import solve_vep

FROZEN_RTOL = 1.0e-9
N = 24
NIT = 400


def _powerlaw_material(dilation=10.0):
    """Two phases: shared-n dislocation creep and a diffusion-creep phase —
    a creep table that collapses to 1/η = A + B·τII²."""
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=5.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=dilation, eta_reg=1e-2)
    return MaterialStack.make([
        Material(G=1.0, disl_A=0.4, disl_n=3.0, disl_E=1.0e3, **common),
        Material(G=0.5, diff_A=0.3, diff_m=1.0, grain_size=0.5,
                 diff_E=5.0e2, **common)])


def _linear_material(Kb, dilation):
    C = 1.6 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=Kb, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=dilation, eta_reg=1e-2)
    return MaterialStack.make(
        [Material(G=1.0, **common), Material(G=0.5, **common)])


def _dpcap_material():
    """Dilatant Drucker-Prager with the tension cap (ψ = 3°, pT = −0.5) at a
    cohesion low enough to yield within one solve."""
    C = 0.3 / math.cos(math.radians(30.0))
    common = dict(rho0=0.0, Kb=4.0, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=3.0, eta_reg=1e-3,
                  tension_pT=-0.5)
    return MaterialStack.make(
        [Material(G=1.0, **common), Material(G=0.5, **common)])


def _pure_shear(case):
    """The two-phase pure-shear problem of each variant, as the positional
    and keyword arguments of ``solve_vep``."""
    n = N
    geometry = Geometry((n, n), (1.0, 1.0))
    xci, xvi = geometry.xci, geometry.xvi
    pr_c = jnp.asarray(_circle_phase_ratios(xci[0], xci[1], (0.5, 0.5), 0.1))
    pr_v = jnp.asarray(_circle_phase_ratios(xvi[0], xvi[1], (0.5, 0.5), 0.1))
    if case == "noslip" or case == "powerlaw":
        bc = VelocityBoundaryConditions(free_slip=Faces(left=True, right=True),
                                        no_slip=Faces(top=True, bot=True))
    else:
        bc = VelocityBoundaryConditions(
            free_slip=Faces(left=True, right=True, top=True, bot=True))
    material = {
        "compressible": lambda: _linear_material(5.0, 10.0),
        "incompressible": lambda: _linear_material(jnp.inf, 0.0),
        "nearly_incompressible": lambda: _linear_material(1.0e12, 0.0),
        "noslip": lambda: _linear_material(5.0, 0.0),
        "powerlaw": lambda: _powerlaw_material(dilation=0.0),
        "dpcap": lambda: _dpcap_material(),
    }[case]()
    st = StokesState.make((n, n))
    xv = jnp.asarray(xvi[0])
    yv = jnp.asarray(xvi[1])
    Vx = jnp.broadcast_to(xv[:, None], (n + 1, n + 2))
    Vy = jnp.broadcast_to((-yv)[None, :], (n + 2, n + 1))
    Vx, Vy = flow_bcs((Vx, Vy), bc)
    st = st.replace(V=st.V.replace(Vx=Vx, Vy=Vy))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.75 / math.sqrt(2.1))
    kw = dict(iter_max=NIT, iter_min=NIT, nout=100)
    if case == "powerlaw":
        xc = jnp.asarray(geometry.xci[0])
        kw["T"] = 300.0 + 50.0 * jnp.sin(2.0 * jnp.pi * xc[:, None]) \
            * jnp.ones((1, n))
    return (st, pt, geometry, bc, material, pr_c, pr_v, 0.25), kw


def _solve(case):
    args, kw = _pure_shear(case)
    out, info = solve_vep(*args, **kw)
    assert int(info.iters) == NIT
    return out


def _summary(out):
    return (float(jnp.abs(out.P).max()), float(out.tau.II.max()),
            float(jnp.abs(out.V.Vy).mean()))


# CPU/f64, N = 24, NIT = 400: (max |P|, max τII, mean |Vy|)
FROZEN = {
    "compressible": (0.10340983883265764, 0.4431420502744548,
                     0.5000000000000001),
    "noslip": (2.6260513393233764, 1.1614270731969496, 0.05667086658192142),
    "powerlaw": (14.797486230875469, 4.68843375201252, 0.3234118461996428),
    "dpcap": (0.05571782800627125, 0.32448410030783, 0.4999999999999999),
}


@pytest.mark.parametrize("case", sorted(FROZEN))
def test_vep2d_variant_frozen(case):
    np.testing.assert_allclose(_summary(_solve(case)), FROZEN[case],
                               rtol=FROZEN_RTOL)


def test_bulk_modulus_limit_is_incompressible():
    """Kb → ∞ recovers the incompressible solve (Kb = inf) to roundoff."""
    a, b = _solve("nearly_incompressible"), _solve("incompressible")
    scale = float(jnp.abs(b.P).max())
    assert float(jnp.abs(a.P - b.P).max()) < 1e-9 * scale
    assert float(jnp.abs(a.tau.II - b.tau.II).max()) < 1e-9 * scale


def test_noslip_walls_hold_zero_tangential_velocity():
    out = _solve("noslip")
    Vx = np.asarray(out.V.Vx)
    # the wall sits between ghost and first interior row: their mean is 0
    np.testing.assert_array_equal(Vx[:, 0], -Vx[:, 1])
    np.testing.assert_array_equal(Vx[:, -1], -Vx[:, -2])
    assert float(out.lam.max()) > 0.0  # and the band yields


def test_dpcap_volumetric_plastic_strain_nonnegative():
    """ε_vol_pl = −λ·∂Q/∂P ≥ 0 on a dilatant yield surface."""
    out = _solve("dpcap")
    assert float(out.lam.max()) > 0.0
    assert float(out.eps_vol_pl.min()) >= 0.0
    assert float(out.eps_vol_pl.max()) > 0.0


def test_buoyancy_rho_T_flow_is_mirror_symmetric():
    """ρ(T)·g from a hot blob centered in x drives a flow that is symmetric
    about the blob's axis: Vy even in x, Vx odd."""
    n = N
    geometry = Geometry((n, n), (1.0, 1.0), origin=(0.0, -1.0))
    # Kb = inf with dt = inf: a finite Kb would make K·dt infinite
    material = Material(rho0=1.0, T0=0.0, alpha=0.5, beta=0.0,
                        G=1.0, eta0=1.0, gravity=1.0)
    bc = VelocityBoundaryConditions(
        free_slip=Faces(left=True, right=True, top=True, bot=True))
    st = StokesState.make((n, n))
    xc = jnp.asarray(geometry.xci[0])
    yc = jnp.asarray(geometry.xci[1])
    T = jnp.exp(-(((xc[:, None] - 0.5) ** 2 + (yc[None, :] + 0.6) ** 2)
                  / 0.02))
    st = st.replace(viscosity=st.viscosity.replace(
        eta=jnp.ones((n, n)), eta_v=jnp.ones((n + 1, n + 1))))
    pt = PTStokesCoeffs.make(geometry.li, geometry.di,
                             CFL=0.9 / math.sqrt(2.1))
    out, info = solve_vep(st, pt, geometry, bc, material, None, None,
                          jnp.inf, T=T, iter_max=NIT, iter_min=NIT, nout=100)
    Vx, Vy = np.asarray(out.V.Vx), np.asarray(out.V.Vy)
    scale = np.abs(Vy).max()
    assert scale > 1e-6  # the flow is driven
    np.testing.assert_allclose(Vy, Vy[::-1, :], rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(Vx, -Vx[::-1, :], rtol=0, atol=1e-10 * scale)


def test_shared_powerlaw_exponent():
    from justrelax_tpu.rheology.viscosity import shared_powerlaw_exponent

    assert shared_powerlaw_exponent(_powerlaw_material()) == 2.0
    common = dict(rho0=0.0, Kb=5.0)
    lin = MaterialStack.make([Material(G=1.0, eta0=2.0, **common)])
    assert shared_powerlaw_exponent(lin) is None  # pure linear: table path
    diff_only = MaterialStack.make(
        [Material(G=1.0, diff_A=0.3, **common), Material(G=1.0, **common)])
    assert shared_powerlaw_exponent(diff_only) == 0.0
    gbs = MaterialStack.make(
        [Material(G=1.0, gbs_A=1.0, gbs_n=2.0, **common)])
    assert shared_powerlaw_exponent(gbs) is None


def test_powerlaw_recip_coeffs_match_phase_viscosity():
    """The collapsed (A, B) coefficients reproduce phase_viscosity's
    tau-mode harmonic blend (incl. the >0.999 dominant-phase exit) at any
    stress."""
    from justrelax_tpu.rheology.viscosity import (
        phase_viscosity,
        powerlaw_recip_coeffs,
        shared_powerlaw_exponent,
    )

    material = _powerlaw_material()
    rng = np.random.default_rng(0)
    ni = (6, 5)
    r0 = rng.uniform(0.0, 1.0, ni)
    r0[0, 0] = 0.9995  # exercise the dominant-phase early exit
    ratios = jnp.asarray(np.stack([r0, 1.0 - r0], axis=-1))
    T = jnp.asarray(250.0 + 100.0 * rng.uniform(size=ni))
    m = shared_powerlaw_exponent(material)
    A, B = powerlaw_recip_coeffs(material, jnp.ones(ni), T, ratios)
    for tau in (1.0e-3, 0.7, 13.0):
        eta_ref = phase_viscosity(
            material, jnp.full(ni, tau), T, ratios, "tau")
        eta_col = 1.0 / (A + B * tau**m)
        np.testing.assert_allclose(
            np.asarray(eta_col), np.asarray(eta_ref), rtol=1e-12)


@pytest.mark.parametrize("plastic", [False, True])
def test_vep3d_pass_split_matches_full(plastic):
    """The 3D return mapping with only its center pass, or only its three
    edge passes (``probe_passes``, which the chip run uses to split the
    iteration's time), computes exactly what the full update computes for
    those lattices; the skipped pass passes its inputs through."""
    from justrelax_tpu.ops.stokes3d_vep import update_stresses_center_edges_3d
    from justrelax_tpu.rheology.phases import phase_ratios_from_field

    n = 6
    ni = (n, n, n)
    rng = np.random.default_rng(1)
    C = (0.05 if plastic else 50.0) / math.cos(math.radians(30.0))
    common = dict(Kb=4.0, eta0=1.0, is_plastic=1.0, C=C,
                  friction_angle=30.0, dilation_angle=5.0, eta_reg=8e-3)
    mat = MaterialStack.make([Material(G=1.0, **common),
                              Material(G=0.5, **common)])
    pr = phase_ratios_from_field(
        jnp.asarray(rng.integers(0, 2, size=ni)), 2)
    edge_shapes = ((n, n + 1, n + 1), (n + 1, n, n + 1), (n + 1, n + 1, n))

    def r(*shape):
        return jnp.asarray(rng.normal(size=shape))

    eps_c = tuple(r(*ni) for _ in range(3))
    eps_e = tuple(r(*s) for s in edge_shapes)
    tau_c = tuple(r(*ni) for _ in range(6))
    tau_e = tuple(r(*s) for s in edge_shapes)
    tau_o_c = tuple(r(*ni) for _ in range(6))
    tau_o_e = tuple(r(*s) for s in edge_shapes)
    lam_e = tuple(jnp.zeros(s) for s in edge_shapes)
    args = (eps_c, eps_e, tau_c, tau_e, tau_o_c, tau_o_e, r(*ni),
            jnp.ones(ni), jnp.zeros(ni), lam_e, jnp.zeros(ni), mat,
            pr.center, (pr.edge_yz, pr.edge_xz, pr.edge_xy), 0.2, 0.25, 1.0)
    full = update_stresses_center_edges_3d(*args)
    center = update_stresses_center_edges_3d(*args, probe_passes=("center",))
    edges = update_stresses_center_edges_3d(*args, probe_passes=("edges",))
    for a, b in zip(full.tau_e, edges.tau_e):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(full.tau_c, center.tau_c):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(full.lam), np.asarray(center.lam))
    for a, b in zip(center.tau_e, tau_e):  # edges skipped: passed through
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (float(full.lam.max()) > 0.0) == plastic
