"""Fused center+edge visco-elasto-plastic stress update, 3D.

Vectorized re-design of the reference 3D kernel
``update_stresses_center_vertex_ps!``
(/root/reference/src/stokes/StressKernels.jl:667-984): one pass computes the
VE trial stress and Drucker-Prager return mapping at cell centers AND the
three shear-edge families (yz, xz, xy), with the reference's exact clamped
interpolation conventions (clamped_indices/av_clamped_* at :601-664 —
including its center-count clamping that skips the outermost face of
cross-family edge arrays). Plastic multipliers λ (centers) and λ_yz/λ_xz/λ_xy
(edges) are relaxed like the 2D kernel; volume closure K·dt·dFdP·dQdP and
dilatancy enter the λ denominator and the corrected pressure.

Branchless: the yield branch becomes ``jnp.where`` masks; divisions by τII
are guarded.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from justrelax_tpu.rheology.materials import get_bulk_modulus, get_shear_modulus
from justrelax_tpu.rheology.plasticity import (
    flow_gradients_P,
    plastic_params_phase,
    yield_function,
)

Array = Any

__all__ = [
    "update_stresses_center_edges_3d",
    "VEPStressResult3D",
    "VEPParams3D",
    "make_vep_params_3d",
    "StaggeredMoves",
    "serial_moves",
]


class StaggeredMoves(NamedTuple):
    """Pluggable staggered interpolation ops for the fused VEP kernel.

    The kernel's math is location-agnostic; what differs between the serial
    and the distributed (shard_map) execution is how values move between the
    center and edge lattices — the serial version clamps indices at the
    global domain edge, the distributed version (parallel/stokes3d_vep.py)
    fetches neighbor-device layers with ``halo.extend`` and applies the
    clamps only on physical-boundary devices.
    """

    center_to_edge: Any  # (A, ax0, ax1) -> edge-family array
    harm_center_to_edge: Any
    other_to_edge: Any  # (src_name, dst_name, A) -> dst-family array
    edge_to_center: Any  # (A, ax0, ax1) -> center array


class VEPParams3D(NamedTuple):
    """Precomputed per-lattice solve-invariants (phase blends with the
    solve-frozen EII/phase ratios, and optionally the clamped edge
    interpolants of the solve-frozen old stress τ_o) for
    :func:`update_stresses_center_edges_3d`.

    The blends involve (..., nphase) arrays with a tiny trailing dimension,
    and the edge passes would otherwise re-interpolate solve-frozen fields
    every iteration — so both are evaluated ONCE per solve."""

    ppc: Any          # PlasticParams at centers
    G_c: Any
    K_c: Any
    ppe: tuple        # PlasticParams per edge family (yz, xz, xy)
    G_e: tuple
    K_e: tuple
    tau_o6_e: Any = None  # per family: 6-tuple of τ_o interpolated to edges


def make_vep_params_3d(material, EII_pl, phase_ratios_center,
                       phase_ratios_edges, tau_o_c6, tau_o_e3,
                       moves: "StaggeredMoves | None" = None) -> VEPParams3D:
    """Hoist everything in the fused stress update that is frozen during a
    PT solve: the phase-blended plastic parameters / moduli (EII and phase
    ratios only move between solves) and the clamped edge interpolants of
    the old stress τ_o (reference reads, e.g. av_clamped_yz(τ_o[1], ...),
    StressKernels.jl:723-728 — identical arithmetic, evaluated once).
    Bitwise-equal to the in-loop evaluation by construction."""
    ni = EII_pl.shape
    names = ("yz", "xz", "xy")
    if moves is None:
        moves = serial_moves(ni)
    ppe, G_e, K_e, tau_o6_e = [], [], [], []
    for k, name in enumerate(names):
        a, b = _EDGE_AXES[name]
        pr_e = phase_ratios_edges[k]
        EII_e = moves.center_to_edge(EII_pl, a, b)
        ppe.append(plastic_params_phase(material, EII_e, pr_e))
        G_e.append(get_shear_modulus(material, pr_e))
        K_e.append(get_bulk_modulus(material, pr_e))
        t_no = [moves.center_to_edge(tau_o_c6[i], a, b) for i in range(3)]
        t_so = []
        for m, mname in enumerate(names):
            if mname == name:
                t_so.append(tau_o_e3[m])
            else:
                t_so.append(moves.other_to_edge(mname, name, tau_o_e3[m]))
        tau_o6_e.append(tuple(t_no) + tuple(t_so))
    return VEPParams3D(
        ppc=plastic_params_phase(material, EII_pl, phase_ratios_center),
        G_c=get_shear_modulus(material, phase_ratios_center),
        K_c=get_bulk_modulus(material, phase_ratios_center),
        ppe=tuple(ppe), G_e=tuple(G_e), K_e=tuple(K_e),
        tau_o6_e=tuple(tau_o6_e),
    )


class VEPStressResult3D(NamedTuple):
    tau_c: tuple  # (xx, yy, zz, yz_c, xz_c, xy_c) centers
    tau_e: tuple  # (yz, xz, xy) edges
    lam: Array
    lam_e: tuple  # (yz, xz, xy)
    tau_II: Array
    eta_vep: Array
    P_corrected: Array
    eps_pl_c: tuple  # (xx, yy, zz, yz_c, xz_c, xy_c) centers
    eps_pl_e: tuple  # (yz, xz, xy) edges
    eps_vol_pl: Array


def _inv_II(t6):
    """3D second invariant of a 6-tuple (xx, yy, zz, yz, xz, xy)."""
    xx, yy, zz, yz, xz, xy = t6
    return jnp.sqrt(0.5 * (xx**2 + yy**2 + zz**2) + yz**2 + xz**2 + xy**2)


def _safe_div(a, b):
    return a / jnp.where(b == 0, 1.0, b)


# --- the reference's clamped staggered moves --------------------------------
def _pair_back(A, axis):
    """Backward clamped pair average: size n → n+1 (A[j-1]+A[j])/2 with edge
    clamp (the j0/jc pattern of clamped_indices)."""
    pad = [(0, 0)] * A.ndim
    pad[axis] = (1, 1)
    P = jnp.pad(A, pad, mode="edge")
    lo = [slice(None)] * A.ndim
    hi = [slice(None)] * A.ndim
    lo[axis], hi[axis] = slice(None, -1), slice(1, None)
    return 0.5 * (P[tuple(lo)] + P[tuple(hi)])


def _pair_fwd(A, axis, n_center):
    """Forward pair average clamped BY CENTER COUNT: reads A[min(i, n-1)],
    A[min(i+1, n-1)] for i = 0..n-1 (the ic/i1 pattern — the reference never
    reads A's last face here)."""
    sl = [slice(None)] * A.ndim
    sl[axis] = slice(None, n_center)
    Ax = A[tuple(sl)]
    pad = [(0, 0)] * A.ndim
    pad[axis] = (0, 1)
    P = jnp.pad(Ax, pad, mode="edge")
    lo = [slice(None)] * A.ndim
    hi = [slice(None)] * A.ndim
    lo[axis], hi[axis] = slice(None, -1), slice(1, None)
    return 0.5 * (P[tuple(lo)] + P[tuple(hi)])


def _idx_clamp(A, axis, n_center):
    """Identity read through the center-count clamp: B[k] = A[min(k, n-1)]
    (drops the outermost face value, reference kc = clamp(k, 1, n))."""
    sl = [slice(None)] * A.ndim
    sl[axis] = slice(None, n_center)
    Ax = A[tuple(sl)]
    extra = A.shape[axis] - n_center
    if extra == 0:
        return Ax
    pad = [(0, 0)] * A.ndim
    pad[axis] = (0, extra)
    return jnp.pad(Ax, pad, mode="edge")


def _center_to_edge(A, ax0, ax1):
    """Clamped center→edge average over the two edge axes (av_clamped_yz etc.)."""
    return _pair_back(_pair_back(A, ax0), ax1)


def _harm_center_to_edge(A, ax0, ax1):
    return 1.0 / _center_to_edge(1.0 / A, ax0, ax1)


def _edge_to_center(A, ax0, ax1):
    """Interior 4-point edge→center average (shear2center)."""
    lo0 = [slice(None)] * 3
    hi0 = [slice(None)] * 3
    lo0[ax0], hi0[ax0] = slice(None, -1), slice(1, None)
    B = 0.5 * (A[tuple(lo0)] + A[tuple(hi0)])
    lo1 = [slice(None)] * 3
    hi1 = [slice(None)] * 3
    lo1[ax1], hi1[ax1] = slice(None, -1), slice(1, None)
    return 0.5 * (B[tuple(lo1)] + B[tuple(hi1)])


def _stress_increment(tau, tau_o, eta, eps, _Gdt, dtau_r):
    return dtau_r * (2.0 * eta * eps - (tau - tau_o) * eta * _Gdt - tau)


# edge-family geometry: (slot, edge axes (a,b), and for each OTHER shear
# family how it maps onto this family's edges: (src_slot, fwd_axis, back_axis,
# idx_axis))
_EDGE_AXES = {"yz": (1, 2), "xz": (0, 2), "xy": (0, 1)}


def serial_moves(ni) -> StaggeredMoves:
    """The single-device clamped moves (reference av_clamped_* conventions,
    StressKernels.jl:601-664), closed over the global center counts ``ni``."""

    def other_to_edge(src_name, dst_name, A):
        """Map shear family ``src`` onto ``dst`` edges with the reference's
        fwd/back/idx clamped moves (av_clamped_<dst>_<axis> helpers)."""
        sa = _EDGE_AXES[src_name]
        da = _EDGE_AXES[dst_name]
        shared = [a for a in sa if a in da]  # one shared staggered axis
        src_only = [a for a in sa if a not in da][0]  # fwd (center-clamped)
        dst_only = [a for a in da if a not in sa][0]  # back pair
        out = _pair_fwd(A, src_only, ni[src_only])
        out = _pair_back(out, dst_only)
        out = _idx_clamp(out, shared[0], ni[shared[0]])
        return out

    return StaggeredMoves(
        center_to_edge=_center_to_edge,
        harm_center_to_edge=_harm_center_to_edge,
        other_to_edge=other_to_edge,
        edge_to_center=_edge_to_center,
    )


def update_stresses_center_edges_3d(
    eps_c3,  # (exx, eyy, ezz) centers
    eps_e3,  # (eyz, exz, exy) edges
    tau_c6,  # current center stress (xx, yy, zz, yz_c, xz_c, xy_c)
    tau_e3,  # current edge shear (yz, xz, xy)
    tau_o_c6,
    tau_o_e3,
    Pr,  # pressure iterate θ (centers)
    eta,  # effective viscosity (centers)
    lam, lam_e3,  # plastic multipliers: centers + 3 edge families
    EII_pl,  # accumulated plastic strain (centers)
    material,
    phase_ratios_center,  # (nx, ny, nz, nphase) or None
    phase_ratios_edges,  # (yz, xz, xy) ratios or (None, None, None)
    rel_lambda: float,
    dt,
    theta_dtau,
    moves: StaggeredMoves | None = None,
    params: "VEPParams3D | None" = None,
    probe_passes=None,
) -> VEPStressResult3D:
    """``probe_passes`` splits the iteration's time by pass (the ``vep3d``
    bench family's ``probe_passes``): ``("center",)`` skips the three edge passes, ``("edges",)`` skips the
    center pass — each skipped pass degenerates to a passthrough with the
    same output shapes so the iteration frame (traffic) is unchanged while
    its compute is removed. Physics callers leave it None."""
    ni = Pr.shape
    names = ("yz", "xz", "xy")
    if moves is None:
        moves = serial_moves(ni)
    other_to_edge = moves.other_to_edge
    do_edges = probe_passes is None or "edges" in probe_passes
    do_center = probe_passes is None or "center" in probe_passes

    # ---------------- edge passes ------------------------------------------
    new_tau_e = []
    new_lam_e = []
    eps_pl_e = []
    for k, name in enumerate(names if do_edges else ()):
        a, b = _EDGE_AXES[name]
        Pv = moves.center_to_edge(Pr, a, b)
        eta_e = moves.harm_center_to_edge(eta, a, b)
        if params is None:
            pr_e = phase_ratios_edges[k]
            EII_e = moves.center_to_edge(EII_pl, a, b)
            ppe = plastic_params_phase(material, EII_e, pr_e)
            G_e = get_shear_modulus(material, pr_e)
            K_e = get_bulk_modulus(material, pr_e)
        else:
            ppe, G_e, K_e = params.ppe[k], params.G_e[k], params.K_e[k]
        _Gedt = 1.0 / (G_e * dt)
        dtau_re = 1.0 / (theta_dtau + eta_e * _Gedt + 1.0)

        # normal components interpolated from centers; τ_o interpolants are
        # solve-frozen — precomputed when params carries them
        hoisted_o = params is not None and params.tau_o6_e is not None
        t_n = [moves.center_to_edge(tau_c6[i], a, b) for i in range(3)]
        if not hoisted_o:
            t_no = [moves.center_to_edge(tau_o_c6[i], a, b) for i in range(3)]
        # this family's own shear lives here; the other two interpolate over
        t_s, t_so, e_s = {}, {}, {}
        for m, mname in enumerate(names):
            if mname == name:
                t_s[mname] = tau_e3[m]
                t_so[mname] = tau_o_e3[m]
                e_s[mname] = eps_e3[m]
            else:
                t_s[mname] = other_to_edge(mname, name, tau_e3[m])
                if not hoisted_o:
                    t_so[mname] = other_to_edge(mname, name, tau_o_e3[m])
                e_s[mname] = other_to_edge(mname, name, eps_e3[m])
        e_n = [moves.center_to_edge(eps_c3[i], a, b) for i in range(3)]

        t6 = tuple(t_n) + (t_s["yz"], t_s["xz"], t_s["xy"])
        if hoisted_o:
            t6o = params.tau_o6_e[k]
        else:
            t6o = tuple(t_no) + (t_so["yz"], t_so["xz"], t_so["xy"])
        e6 = tuple(e_n) + (e_s["yz"], e_s["xz"], e_s["xy"])
        d6 = tuple(
            _stress_increment(t6[i], t6o[i], eta_e, e6[i], _Gedt, dtau_re)
            for i in range(6)
        )
        trial6 = tuple(t6[i] + d6[i] for i in range(6))
        tau_II_e = _inv_II(trial6)

        dFdP_e, dQdP_e = flow_gradients_P(ppe, Pv, tau_II_e)
        volume_e = jnp.where(jnp.isinf(K_e), 0.0, K_e * dt * dFdP_e * dQdP_e)
        F_e = yield_function(ppe, Pv, tau_II_e)
        yield_e = ppe.is_pl & (tau_II_e != 0.0) & (F_e > 0.0)
        lam_new = (1.0 - rel_lambda) * lam_e3[k] + rel_lambda * (
            jnp.maximum(F_e, 0.0) / (eta_e * dtau_re + ppe.eta_reg + volume_e)
        )
        lam_new = jnp.where(yield_e, lam_new, lam_e3[k])
        # tensor convention: shear slot of ∂Q∂τ = pl_frac · τ_trial/(2 τII)
        slot = 3 + k
        dQdt = ppe.pl_frac * 0.5 * _safe_div(trial6[slot], tau_II_e)
        e_pl = jnp.where(yield_e, lam_new * dQdt, 0.0)
        d_own = d6[slot]
        t_new = tau_e3[k] + jnp.where(
            yield_e, d_own - 2.0 * eta_e * e_pl * dtau_re, d_own
        )
        new_tau_e.append(t_new)
        new_lam_e.append(lam_new)
        eps_pl_e.append(e_pl)

    if not do_edges:
        new_tau_e = list(tau_e3)
        new_lam_e = list(lam_e3)
        eps_pl_e = [jnp.zeros_like(t) for t in tau_e3]

    if not do_center:
        return VEPStressResult3D(
            tau_c=tau_c6, tau_e=tuple(new_tau_e), lam=lam,
            lam_e=tuple(new_lam_e), tau_II=_inv_II(tau_c6), eta_vep=eta,
            P_corrected=Pr,
            eps_pl_c=tuple(jnp.zeros_like(t) for t in tau_c6),
            eps_pl_e=tuple(eps_pl_e), eps_vol_pl=jnp.zeros_like(lam),
        )

    # ---------------- center pass ------------------------------------------
    if params is None:
        ppc = plastic_params_phase(material, EII_pl, phase_ratios_center)
        G_c = get_shear_modulus(material, phase_ratios_center)
        K_c = get_bulk_modulus(material, phase_ratios_center)
    else:
        ppc, G_c, K_c = params.ppc, params.G_c, params.K_c
    _Gdt = 1.0 / (G_c * dt)
    dtau_r = 1.0 / (theta_dtau + eta * _Gdt + 1.0)

    e_sc = (
        moves.edge_to_center(eps_e3[0], 1, 2),
        moves.edge_to_center(eps_e3[1], 0, 2),
        moves.edge_to_center(eps_e3[2], 0, 1),
    )
    e6c = tuple(eps_c3) + e_sc
    d6c = tuple(
        _stress_increment(tau_c6[i], tau_o_c6[i], eta, e6c[i], _Gdt, dtau_r)
        for i in range(6)
    )
    trial = tuple(tau_c6[i] + d6c[i] for i in range(6))
    tau_II_t = _inv_II(trial)

    dFdP, dQdP = flow_gradients_P(ppc, Pr, tau_II_t)
    volume = jnp.where(jnp.isinf(K_c), 0.0, K_c * dt * dFdP * dQdP)
    F = yield_function(ppc, Pr, tau_II_t)
    yield_c = ppc.is_pl & (tau_II_t != 0.0) & (F > 0.0)
    lam_new = (1.0 - rel_lambda) * lam + rel_lambda * (
        jnp.maximum(F, 0.0) / (eta * dtau_r + ppc.eta_reg + volume)
    )
    lam_new = jnp.where(yield_c, lam_new, lam)

    scale = ppc.pl_frac * 0.5
    eps_pl_c = tuple(
        jnp.where(yield_c, lam_new * scale * _safe_div(trial[i], tau_II_t), 0.0)
        for i in range(6)
    )
    corr = 2.0 * eta * dtau_r
    tau_new = tuple(
        jnp.where(yield_c, trial[i] - corr * eps_pl_c[i], trial[i])
        for i in range(6)
    )
    eps_vol_pl = jnp.where(yield_c, -lam_new * dQdP, 0.0)
    tau_II = jnp.where(yield_c, _inv_II(tau_new), tau_II_t)
    eps_II = _inv_II(e6c)
    eta_vep = tau_II * 0.5 * _safe_div(jnp.ones_like(eps_II), eps_II)
    P_corr = Pr - jnp.where(jnp.isinf(K_c), 0.0, K_c * dt * lam_new * dQdP)

    return VEPStressResult3D(
        tau_c=tau_new,
        tau_e=tuple(new_tau_e),
        lam=lam_new,
        lam_e=tuple(new_lam_e),
        tau_II=tau_II,
        eta_vep=eta_vep,
        P_corrected=P_corr,
        eps_pl_c=eps_pl_c,
        eps_pl_e=tuple(eps_pl_e),
        eps_vol_pl=eps_vol_pl,
    )
