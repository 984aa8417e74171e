"""Collocated-canvas 3D VEP iteration (XLA roll+mask formulation).

Why this exists: in the slice/pad 3D VEP iteration (solvers/stokes3d_vep.py
one_iteration over ops/stokes3d_vep.py) the fused center+edges return
mapping interpolates the full 6-component stress/strain state onto three
edge lattices with ~60 clamped moves of MIXED staggered shapes, which can
fragment XLA's fusion clusters. Here every field lives in one (nx+2, ny+2, nz+2)
canvas (collocation identical to ops/stokes3d_canvas.py), every clamped
move is a static roll plus a boundary select, and the whole iteration is a
uniform-shape elementwise graph.

The return-mapping math is NOT duplicated: the canvas path drives the same
``update_stresses_center_edges_3d`` (ops/stokes3d_vep.py — reference
update_stresses_center_vertex_ps!, src/stokes/StressKernels.jl:667-984)
through a canvas-collocated :class:`StaggeredMoves`:

- ``center_to_edge`` (av_clamped_*): per axis, refresh the canvas ghost
  slabs from the adjacent interior (edge clamp ≡ replicated ghost) and
  pair-average with a static roll;
- ``other_to_edge``: the fwd/back/idx clamped moves become
  select-at-the-last-staggered-slot + roll averages;
- ``edge_to_center``: plain interior 4-point roll averages.

Every phase blend is PRECOMPUTED at consts-build time (plastic parameters,
moduli, the ρ(T,P)·g affine coefficients, the collapsed power-law viscosity
target) so no (..., nphase) trailing-tiny-dim math enters the loop;
loop-invariant derived quantities (the clamped τ_o interpolants) are hoisted
at consts-build time too.

Whether this layout or the slice/pad one is faster on a given device is a
benchmark question (the ``vep3d`` and ``vep3d_canvas`` bench families).

Supported configuration: uniform grid,
all-free-slip BCs, no variational mask (phi), default solver options, and
a creep table that is linear or collapses to a shared-exponent power law —
the ShearBand3D / bench ``vep3d`` family configuration.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax.numpy as jnp
from jax import lax

from justrelax_tpu.ops.stokes import compute_P
from justrelax_tpu.ops.stokes3d_canvas import _band, shift_fns
from justrelax_tpu.ops.stokes3d_vep import (
    StaggeredMoves,
    _inv_II,
    update_stresses_center_edges_3d,
)
from justrelax_tpu.rheology.materials import (
    phase_average,
    _as_stack,
)
from justrelax_tpu.rheology.viscosity import (
    continuation_linear,
    phase_viscosity,
)

Array = Any

__all__ = [
    "VEP3DCanvasConsts",
    "VEP3DCanvasCarry",
    "canvas_moves",
    "embed_center",
    "embed_edge",
    "extract_center",
    "extract_edge",
    "vep3d_canvas_consts",
    "iteration_vep3d_canvas",
    "vep3d_chunk_canvas",
]

_EDGE_PADS = {
    0: ((1, 1), (0, 1), (0, 1)),  # yz edges at (i+1, j, k)
    1: ((0, 1), (1, 1), (0, 1)),  # xz edges at (i, j+1, k)
    2: ((0, 1), (0, 1), (1, 1)),  # xy edges at (i, j, k+1)
}
_EDGE_AXES3 = ((1, 2), (0, 2), (0, 1))


def embed_center(A, mode="constant"):
    """(nx, ny, nz[, p]) cell field → canvas at slots (i+1, j+1, k+1)."""
    pads = ((1, 1), (1, 1), (1, 1)) + ((0, 0),) * (A.ndim - 3)
    return jnp.pad(A, pads, mode=mode)


def embed_edge(A, fam, mode="constant"):
    """Edge-family field → canvas (fam 0=yz, 1=xz, 2=xy)."""
    pads = _EDGE_PADS[fam] + ((0, 0),) * (A.ndim - 3)
    return jnp.pad(A, pads, mode=mode)


def extract_center(C):
    return C[1:-1, 1:-1, 1:-1]


def extract_edge(C, fam):
    sl = tuple(
        slice(1, -1) if p == (1, 1) else slice(None, -1)
        for p in _EDGE_PADS[fam]
    )
    return C[sl]


def _ghost_refresh(A, ax, n, sm1, sp1):
    """Replicate the interior boundary values into the ghost slabs of a
    CENTER-collocated canvas axis (slots 1..n interior): slot 0 ← slot 1,
    slot n+1 ← slot n. Equivalent to the reference's clamped indexing."""
    lo = _band(A.shape[:3], ax, 0, 0)
    hi = _band(A.shape[:3], ax, n + 1, n + 1)
    if A.ndim > 3:
        lo, hi = lo[..., None], hi[..., None]
    return jnp.where(lo, sm1(A, ax), jnp.where(hi, sp1(A, ax), A))


def canvas_moves(ni, shift="slice") -> StaggeredMoves:
    """Canvas-collocated clamped staggered moves (≙ serial_moves, but every
    array is an (nx+2, ny+2, nz+2) canvas; proven equal in
    tests/test_vep3d_canvas.py)."""
    n_ax = ni
    _sm1, _sp1 = shift_fns(shift)

    def center_to_edge(A, a, b):
        out = A
        for ax in (a, b):
            out = _ghost_refresh(out, ax, n_ax[ax], _sm1, _sp1)
            out = 0.5 * (out + _sm1(out, ax))
        return out

    def harm_center_to_edge(A, a, b):
        return 1.0 / center_to_edge(1.0 / A, a, b)

    def other_to_edge(src_name, dst_name, A):
        from justrelax_tpu.ops.stokes3d_vep import _EDGE_AXES

        sa = _EDGE_AXES[src_name]
        da = _EDGE_AXES[dst_name]
        shared = [a for a in sa if a in da][0]
        src_only = [a for a in sa if a not in da][0]
        dst_only = [a for a in da if a not in sa][0]
        n = n_ax[src_only]
        # _pair_fwd (center-count clamp: the outermost staggered face along
        # src_only is never read): replace slot n with slot n-1, then
        # backward pair-average onto center slots 1..n
        last = _band(A.shape, src_only, n, n)
        Ax = jnp.where(last, _sp1(A, src_only), A)
        out = 0.5 * (_sp1(Ax, src_only) + Ax)
        # _pair_back along the destination's extra staggered axis
        out = _ghost_refresh(out, dst_only, n_ax[dst_only], _sm1, _sp1)
        out = 0.5 * (out + _sm1(out, dst_only))
        # _idx_clamp along the shared staggered axis (slot n ← slot n-1)
        ns = n_ax[shared]
        lasts = _band(out.shape, shared, ns, ns)
        return jnp.where(lasts, _sp1(out, shared), out)

    def edge_to_center(A, ax0, ax1):
        out = 0.5 * (_sp1(A, ax0) + A)
        return 0.5 * (_sp1(out, ax1) + out)

    return StaggeredMoves(
        center_to_edge=center_to_edge,
        harm_center_to_edge=harm_center_to_edge,
        other_to_edge=other_to_edge,
        edge_to_center=edge_to_center,
    )


def _maxloc_canvas(A, ni, sm1, sp1):
    """maxloc(window=1) with clamped boundaries on a center canvas
    (ops/stencil.py::maxloc semantics: separable per-axis 3-point max with
    edge clamping ≡ ghost replication)."""
    B = A
    for ax in range(3):
        B = _ghost_refresh(B, ax, ni[ax], sm1, sp1)
        B = jnp.maximum(B, jnp.maximum(sm1(B, ax), sp1(B, ax)))
    return B


class VEP3DCanvasConsts(NamedTuple):
    """Loop-invariant canvases, ALL phase blending done at build time.

    Every phase-blended quantity is precomputed per lattice, as are the
    τ_o edge interpolants; only 3D canvases ever enter the loop."""

    params: Any               # VEPParams3D of canvases (plastic + moduli)
    tau_o_c: tuple            # 6 center canvases
    tau_o_e: tuple            # 3 edge canvases
    P0: Array
    Q: Array
    fzA: Optional[Array]      # buoyancy affine coeffs: fz_cell = fzA + fzB·P
    fzB: Optional[Array]      #   (None, None ⇒ zero body force)
    visc_eta: Optional[Array]  # linear creep: constant viscosity target
    visc_A: Optional[Array]   # else collapsed power law 1/η = A + B·τII^m
    visc_B: Optional[Array]
    visc_m: Any               # static float exponent (None ⇒ linear)


class VEP3DCanvasCarry(NamedTuple):
    V: tuple                  # (Vx, Vy, Vz) face canvases (pack_carry slots)
    P: Array
    theta: Array
    tau_c: tuple              # 6 center canvases
    tau_e: tuple              # 3 edge canvases
    eta: Array
    lam: Array
    lam_e: tuple              # 3 edge canvases


def vep3d_canvas_consts(material, tau_o_c6, tau_o_e3, EII_pl, P0, Q,
                        phase_ratios_center, phase_ratios_edges,
                        T=None, visc_m="auto") -> VEP3DCanvasConsts:
    """Build the loop-invariant canvases (one-time cost per solve).

    ``visc_m`` is the shared power-law exponent minus one of the creep
    table (``rheology.viscosity.shared_powerlaw_exponent``), ``None`` for a
    linear table, or "auto" to resolve from a CONCRETE material (raises
    under jit tracing — pass it explicitly there)."""
    from justrelax_tpu.ops.stokes3d_vep import VEPParams3D
    from justrelax_tpu.rheology.materials import (
        get_bulk_modulus,
        get_shear_modulus,
    )
    from justrelax_tpu.rheology.plasticity import plastic_params_phase
    from justrelax_tpu.rheology.viscosity import (
        powerlaw_recip_coeffs,
        shared_powerlaw_exponent,
    )

    pr_c = phase_ratios_center
    pr_cc = None if pr_c is None else embed_center(pr_c, mode="edge")
    pr_ec = tuple(
        None if p is None else embed_edge(p, k, mode="edge")
        for k, p in enumerate(phase_ratios_edges)
    )
    EII_c = embed_center(EII_pl, mode="edge")
    T_c = None if T is None else embed_center(T, mode="edge")
    moves = canvas_moves(EII_pl.shape)

    ppc = plastic_params_phase(material, EII_c, pr_cc)
    G_c = get_shear_modulus(material, pr_cc)
    K_c = get_bulk_modulus(material, pr_cc)
    tau_oc_canvas = tuple(embed_center(t) for t in tau_o_c6)
    tau_oe_canvas = tuple(embed_edge(t, k) for k, t in enumerate(tau_o_e3))
    names3 = ("yz", "xz", "xy")
    ppe, G_e, K_e, tau_o6_e = [], [], [], []
    for k, (a, b) in enumerate(_EDGE_AXES3):
        EII_e = moves.center_to_edge(EII_c, a, b)
        ppe.append(plastic_params_phase(material, EII_e, pr_ec[k]))
        G_e.append(get_shear_modulus(material, pr_ec[k]))
        K_e.append(get_bulk_modulus(material, pr_ec[k]))
        # τ_o edge interpolants are solve-frozen — hoisted like the blends
        t_no = [moves.center_to_edge(tau_oc_canvas[i], a, b) for i in range(3)]
        t_so = []
        for m, mname in enumerate(names3):
            if m == k:
                t_so.append(tau_oe_canvas[m])
            else:
                t_so.append(moves.other_to_edge(mname, names3[k],
                                                tau_oe_canvas[m]))
        tau_o6_e.append(tuple(t_no) + tuple(t_so))
    params = VEPParams3D(
        ppc=ppc, G_c=G_c, K_c=K_c,
        ppe=tuple(ppe), G_e=tuple(G_e), K_e=tuple(K_e),
        tau_o6_e=tuple(tau_o6_e),
    )

    # buoyancy: ρ(T, P)·g is affine in P with T frozen (phase_average is
    # linear) — exactly the density law of materials.compute_density:
    # ρ = Σ_p r·[ρ0(1−α(T−T0)) + ρ0·β·(P−P0_mat)] = Aρ + Bρ·P
    m = _as_stack(material).params
    import numpy as _np
    any_rho = True
    try:
        any_rho = bool(_np.any(_np.asarray(m.rho0) != 0))
    except Exception:
        pass
    if any_rho:
        ref = EII_c
        from justrelax_tpu.rheology.materials import _bcast

        rho0 = _bcast(m.rho0, ref)
        A_p = rho0
        if T_c is not None:
            A_p = A_p * (1.0 - _bcast(m.alpha, ref)
                         * (T_c[..., None] - _bcast(m.T0, ref)))
        beta = _bcast(m.beta, ref)
        B_p = rho0 * beta
        A_p = A_p - B_p * _bcast(m.P0, ref)
        B_p = jnp.broadcast_to(B_p, ref.shape + (B_p.shape[-1],))
        A_rho = phase_average(A_p, pr_cc)
        B_rho = phase_average(B_p, pr_cc)
        g = phase_average(m.gravity, pr_cc)
        g = jnp.broadcast_to(g, A_rho.shape)
        fzA, fzB = A_rho * g, B_rho * g
    else:
        fzA = fzB = None

    if visc_m == "auto":
        visc_m = shared_powerlaw_exponent(material)
        if visc_m is None and bool(
            _np.any(_np.asarray(m.disl_A) > 0)
            | _np.any(_np.asarray(m.diff_A) > 0)
            | _np.any(_np.asarray(m.peierls_A) > 0)
            | _np.any(_np.asarray(m.gbs_A) > 0)
        ):
            raise ValueError(
                "canvas VEP needs a creep table that is linear or collapses "
                "to a shared-exponent power law (shared_powerlaw_exponent)"
            )
    if visc_m is None:
        # linear table: the tau-mode viscosity is invariant of tII — one
        # phase_viscosity evaluation IS the refresh target, bitwise
        visc_eta = phase_viscosity(
            material, jnp.ones_like(EII_c), T_c, pr_cc, "tau")
        visc_A = visc_B = None
    else:
        visc_eta = None
        visc_A, visc_B = powerlaw_recip_coeffs(material, EII_c, T_c, pr_cc)

    return VEP3DCanvasConsts(
        params=params,
        tau_o_c=tau_oc_canvas,
        tau_o_e=tau_oe_canvas,
        P0=embed_center(P0),
        Q=embed_center(Q),
        fzA=fzA, fzB=fzB,
        visc_eta=visc_eta, visc_A=visc_A, visc_B=visc_B, visc_m=visc_m,
    )


def iteration_vep3d_canvas(
    c: VEP3DCanvasCarry,
    co: VEP3DCanvasConsts,
    material,
    inv_di,
    *,
    nx, ny, nz,
    dt,
    r, theta_dtau, etadtau,
    lambda_relaxation,
    viscosity_relaxation,
    viscosity_cutoff=(-jnp.inf, jnp.inf),
    shift="slice",
):
    """One fused 3D VEP PT iteration on collocated canvases — semantics of
    solvers/stokes3d_vep.py::one_iteration (maxloc → θ update → ρ(T,P)·g →
    strain rate → fused center+edges return mapping → τII viscosity
    continuation → damped velocity update + free-slip BCs). ``shift``
    picks the neighbor-shift lowering (ops/stokes3d_canvas.py)."""
    ni = (nx, ny, nz)
    _sm1, _sp1 = shift_fns(shift)
    moves = canvas_moves(ni, shift=shift)
    Vx, Vy, Vz = c.V
    inv_dx, inv_dy, inv_dz = inv_di
    shape = c.P.shape
    dtype = c.P.dtype

    def xb(lo, hi):
        return _band(shape, 0, lo, hi)

    def yb(lo, hi):
        return _band(shape, 1, lo, hi)

    def zb(lo, hi):
        return _band(shape, 2, lo, hi)

    Mc = xb(1, nx) & yb(1, ny) & zb(1, nz)
    # VEP updates the FULL edge lattices (boundary edges included), matching
    # update_stresses_center_edges_3d on the staggered arrays
    Me = (
        xb(1, nx) & yb(0, ny) & zb(0, nz),
        xb(0, nx) & yb(1, ny) & zb(0, nz),
        xb(0, nx) & yb(0, ny) & zb(1, nz),
    )
    MVx = xb(1, nx - 1) & yb(1, ny) & zb(1, nz)
    MVy = xb(1, nx) & yb(1, ny - 1) & zb(1, nz)
    MVz = xb(1, nx) & yb(1, ny) & zb(1, nz - 1)

    # 1. maxloc preconditioner + divergence + compressible θ iterate
    eta_tau = _maxloc_canvas(c.eta, ni, _sm1, _sp1)
    dVxdx = (Vx - _sp1(Vx, 0)) * inv_dx
    dVydy = (Vy - _sp1(Vy, 1)) * inv_dy
    dVzdz = (Vz - _sp1(Vz, 2)) * inv_dz
    grad_V = dVxdx + dVydy + dVzdz
    _, theta = compute_P(
        c.theta, co.P0, grad_V, co.Q, eta_tau, co.params.K_c, co.params.G_c,
        dt, r, theta_dtau
    )
    theta = jnp.where(Mc, theta, c.theta)

    # 2. buoyancy from the PREVIOUS corrected pressure (solver order):
    # ρ(T, P)·g as the precomputed affine form fzA + fzB·P
    if co.fzA is not None:
        fz_cell = co.fzA + co.fzB * c.P
        fz = 0.5 * (fz_cell + _sm1(fz_cell, 2))
    else:
        fz = None

    # 3. strain rates (canvas twin of compute_strain_rate_3d)
    third = 1.0 / 3.0
    exx = dVxdx - grad_V * third
    eyy = dVydy - grad_V * third
    ezz = dVzdz - grad_V * third
    eyz = 0.5 * ((_sm1(Vy, 2) - Vy) * inv_dz + (_sm1(Vz, 1) - Vz) * inv_dy)
    exz = 0.5 * ((_sm1(Vx, 2) - Vx) * inv_dz + (_sm1(Vz, 0) - Vz) * inv_dx)
    exy = 0.5 * ((_sm1(Vx, 1) - Vx) * inv_dy + (_sm1(Vy, 0) - Vy) * inv_dx)

    # 4. fused center+edges return mapping — the EXACT serial kernel body,
    # driven through canvas-collocated moves and the precomputed
    # phase-blended parameter canvases (no (..., nphase) math in the loop)
    res = update_stresses_center_edges_3d(
        (exx, eyy, ezz), (eyz, exz, exy),
        c.tau_c, c.tau_e, co.tau_o_c, co.tau_o_e,
        theta, c.eta, c.lam, c.lam_e, None,
        material, None, (None, None, None),
        lambda_relaxation, dt, theta_dtau,
        moves=moves, params=co.params,
    )
    tau_c = tuple(
        jnp.where(Mc, t, old) for t, old in zip(res.tau_c, c.tau_c)
    )
    tau_e = tuple(
        jnp.where(m, t, old) for m, t, old in zip(Me, res.tau_e, c.tau_e)
    )
    lam = jnp.where(Mc, res.lam, c.lam)
    lam_e = tuple(
        jnp.where(m, t, old) for m, t, old in zip(Me, res.lam_e, c.lam_e)
    )
    P = jnp.where(Mc, res.P_corrected, c.P)

    # 5. τII viscosity continuation (solver refresh_viscosity): the creep
    # target is the precomputed constant canvas (linear table) or the
    # collapsed power law 1/η = A + B·τII^m
    eps0 = jnp.where(
        sum(jnp.abs(t) for t in tau_c) == 0, jnp.finfo(dtype).eps, 0.0
    )
    tII = _inv_II((tau_c[0] + eps0,) + tau_c[1:])
    if co.visc_m is None:
        eta_n = co.visc_eta
    else:
        eta_n = 1.0 / (co.visc_A + co.visc_B * tII ** co.visc_m)
    eta_n = continuation_linear(eta_n, c.eta, viscosity_relaxation)
    eta = jnp.clip(eta_n, viscosity_cutoff[0], viscosity_cutoff[1])
    eta = jnp.where(Mc, eta, c.eta)

    # 6. damped velocity update on interior faces + free-slip mirrors
    txx, tyy, tzz = tau_c[:3]
    tyz, txz, txy = tau_e
    # face averages of ητ on interior faces read interior cells only
    etat = eta_tau
    rx = (
        (_sm1(txx, 0) - txx) * inv_dx
        + (txy - _sp1(txy, 1)) * inv_dy
        + (txz - _sp1(txz, 2)) * inv_dz
        - (_sm1(P, 0) - P) * inv_dx
    )
    Vx = jnp.where(
        MVx, Vx + rx * (etadtau / (0.5 * (etat + _sm1(etat, 0)))), Vx
    )
    ry = (
        (txy - _sp1(txy, 0)) * inv_dx
        + (_sm1(tyy, 1) - tyy) * inv_dy
        + (tyz - _sp1(tyz, 2)) * inv_dz
        - (_sm1(P, 1) - P) * inv_dy
    )
    Vy = jnp.where(
        MVy, Vy + ry * (etadtau / (0.5 * (etat + _sm1(etat, 1)))), Vy
    )
    rz = (
        (txz - _sp1(txz, 0)) * inv_dx
        + (tyz - _sp1(tyz, 1)) * inv_dy
        + (_sm1(tzz, 2) - tzz) * inv_dz
        - (_sm1(P, 2) - P) * inv_dz
    )
    if fz is not None:
        rz = rz - fz
    Vz = jnp.where(
        MVz, Vz + rz * (etadtau / (0.5 * (etat + _sm1(etat, 2)))), Vz
    )

    # free-slip tangential mirrors, serial .at[].set order (ops/bc.py)
    front = yb(0, 0)
    back = yb(ny + 1, ny + 1)
    Vx = jnp.where(front, _sm1(Vx, 1), Vx)
    Vz = jnp.where(front, _sm1(Vz, 1), Vz)
    Vx = jnp.where(back, _sp1(Vx, 1), Vx)
    Vz = jnp.where(back, _sp1(Vz, 1), Vz)
    top = zb(0, 0)
    bot = zb(nz + 1, nz + 1)
    Vx = jnp.where(top, _sm1(Vx, 2), Vx)
    Vy = jnp.where(top, _sm1(Vy, 2), Vy)
    Vx = jnp.where(bot, _sp1(Vx, 2), Vx)
    Vy = jnp.where(bot, _sp1(Vy, 2), Vy)
    left = xb(0, 0)
    right = xb(nx + 1, nx + 1)
    Vy = jnp.where(left, _sm1(Vy, 0), Vy)
    Vz = jnp.where(left, _sm1(Vz, 0), Vz)
    Vy = jnp.where(right, _sp1(Vy, 0), Vy)
    Vz = jnp.where(right, _sp1(Vz, 0), Vz)

    return VEP3DCanvasCarry(
        V=(Vx, Vy, Vz), P=P, theta=theta, tau_c=tau_c, tau_e=tau_e,
        eta=eta, lam=lam, lam_e=lam_e,
    )


def vep3d_chunk_canvas(
    c: VEP3DCanvasCarry,
    co: VEP3DCanvasConsts,
    material,
    inv_di,
    nout,
    **kw,
):
    """Advance ``nout`` fused canvas VEP iterations under ``lax.fori_loop``.
    ``nout`` may be traced."""
    shape = c.P.shape
    nx, ny, nz = shape[0] - 2, shape[1] - 2, shape[2] - 2

    def body(_, carry):
        return iteration_vep3d_canvas(
            carry, co, material, inv_di, nx=nx, ny=ny, nz=nz, **kw
        )

    return lax.fori_loop(0, nout, body, c)


def pack_vep_carry(V, P, theta, tau_c, tau_e, eta, lam,
                   lam_e) -> VEP3DCanvasCarry:
    """Staggered solver fields → canvas carry (solver core-field order)."""
    Vx, Vy, Vz = V
    return VEP3DCanvasCarry(
        V=(jnp.pad(Vx, ((0, 1), (0, 0), (0, 0))),
           jnp.pad(Vy, ((0, 0), (0, 1), (0, 0))),
           jnp.pad(Vz, ((0, 0), (0, 0), (0, 1)))),
        P=embed_center(P),
        theta=embed_center(theta),
        tau_c=tuple(embed_center(t) for t in tau_c),
        tau_e=tuple(embed_edge(t, k) for k, t in enumerate(tau_e)),
        eta=embed_center(eta),
        lam=embed_center(lam),
        lam_e=tuple(embed_edge(t, k) for k, t in enumerate(lam_e)),
    )


def unpack_vep_carry(c: VEP3DCanvasCarry):
    """Inverse of :func:`pack_vep_carry`."""
    Vx, Vy, Vz = c.V
    return (
        (Vx[:-1], Vy[:, :-1], Vz[:, :, :-1]),
        extract_center(c.P),
        extract_center(c.theta),
        tuple(extract_center(t) for t in c.tau_c),
        tuple(extract_edge(t, k) for k, t in enumerate(c.tau_e)),
        extract_center(c.eta),
        extract_center(c.lam),
        tuple(extract_edge(t, k) for k, t in enumerate(c.lam_e)),
    )
