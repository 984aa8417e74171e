"""Collocated-canvas 3D VE Stokes iteration (XLA roll+mask formulation).

Why this exists: in the slice/pad 3D iteration (ops/stokes3d.py) the mixed
staggered shapes (each offset slice is a different-shaped operand) can
fragment XLA's fusion clusters and materialize intermediates. Here every
field is embedded in one (nx+2, ny+2, nz+2) canvas, neighbor access is a
static ±1 shift, and staggered-subgrid ownership is ``broadcasted_iota``
band masks: uniform shapes give the fusion heuristics one elementwise graph,
and all chunk-invariant coefficients are hoisted out of the ``fori_loop``.
Which layout is faster on a given device is a benchmark question (the
``ve3d`` and ``ve3d_canvas`` bench families).

VE/compressible physics enters through the same chunk-invariant COEFFICIENT
form as the 2D kernels:

    P   <- P*c1 + c2 - grad_V*c3
    tau <- a*tau + b*eps + d        (per cell and per edge family;
                                     d folds eta*_Gdt*tau_o)

with the viscous incompressible limit c1=1, c2=0, c3=ητ·r/θ, a=1−dτ_r,
b=2η·dτ_r, d=0 (coefficients that are statically trivial are omitted from
the expression entirely).

Canvas collocation (serial equivalence of the body is proven against the op
composition in tests/test_stokes3d_canvas.py):
  cell (i,j,k)        -> (i+1, j+1, k+1)   P, τxx, τyy, τzz + cell coeffs
  Vx face i           -> a=i   (b=j+1, c=k+1; transverse ghosts included)
  Vy face j           -> b=j   (a=i+1, c=k+1)
  Vz face k           -> c=k   (a=i+1, b=j+1)
  τyz edge (i,j,k)    -> (i+1, j,   k)
  τxz edge (i,j,k)    -> (i,   j+1, k)
  τxy edge (i,j,k)    -> (i,   j,   k+1)

Reference formulas: VelocityKernels.jl:59-242, StressKernels.jl:148-232,
PressureKernels.jl:186-206 (via the serial kernels in ops/stokes3d.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax.numpy as jnp
from jax import lax

Array = Any


def _embed(A, pads):
    return jnp.pad(A, pads)


def pack_carry(Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy):
    """Staggered arrays → stacked carry canvas (10, nx+2, ny+2, nz+2)."""
    return jnp.stack([
        _embed(Vx, ((0, 1), (0, 0), (0, 0))),
        _embed(Vy, ((0, 0), (0, 1), (0, 0))),
        _embed(Vz, ((0, 0), (0, 0), (0, 1))),
        _embed(P, ((1, 1), (1, 1), (1, 1))),
        _embed(txx, ((1, 1), (1, 1), (1, 1))),
        _embed(tyy, ((1, 1), (1, 1), (1, 1))),
        _embed(tzz, ((1, 1), (1, 1), (1, 1))),
        _embed(tyz, ((1, 1), (0, 1), (0, 1))),
        _embed(txz, ((0, 1), (1, 1), (0, 1))),
        _embed(txy, ((0, 1), (0, 1), (1, 1))),
    ])


def unpack_carry(C, nx, ny, nz):
    """Inverse of :func:`pack_carry`."""
    return (
        C[0][:-1, :, :],                # Vx (nx+1, ny+2, nz+2)
        C[1][:, :-1, :],                # Vy
        C[2][:, :, :-1],                # Vz
        C[3][1:-1, 1:-1, 1:-1],         # P
        C[4][1:-1, 1:-1, 1:-1],
        C[5][1:-1, 1:-1, 1:-1],
        C[6][1:-1, 1:-1, 1:-1],
        C[7][1:-1, :-1, :-1],           # tyz (nx, ny+1, nz+1)
        C[8][:-1, 1:-1, :-1],           # txz
        C[9][:-1, :-1, 1:-1],           # txy
    )

__all__ = [
    "CanvasCoeffs3D",
    "LeanConsts3D",
    "ve3d_canvas_coefficients",
    "lean_canvas_consts",
    "iteration3d_canvas",
    "stokes3d_chunk_canvas",
    "stokes3d_chunk_canvas_lean",
    "shift_fns",
    "pack_carry",
    "unpack_carry",
]


# Neighbor shifts, two lowerings. "roll" lowers to concatenate(slice, slice);
# "slice" to slice(pad), zero-filled wrap slots, which XLA folds to one Pad
# op. The two differ only in canvas slots that are never consumed (every
# shifted read is inside jnp.where(mask, ...) whose mask excludes
# wrap-sourced slots), so iteration results are BITWISE identical
# (tests/test_stokes3d_canvas.py). A concatenate forces its operands to
# materialize while a pad can fuse into its consumer, so "slice" is the
# default. Select via the `shift` parameter of the iteration/chunk entry
# points.
def _sm1(A, ax):
    return jnp.roll(A, -1, axis=ax)


def _sp1(A, ax):
    return jnp.roll(A, 1, axis=ax)


def _sm1_slice(A, ax):
    pads = [(0, 0)] * A.ndim
    pads[ax] = (0, 1)
    sl = [slice(None)] * A.ndim
    sl[ax] = slice(1, None)
    return jnp.pad(A, pads)[tuple(sl)]


def _sp1_slice(A, ax):
    pads = [(0, 0)] * A.ndim
    pads[ax] = (1, 0)
    sl = [slice(None)] * A.ndim
    sl[ax] = slice(None, -1)
    return jnp.pad(A, pads)[tuple(sl)]


def shift_fns(shift: str):
    """(_sm1, _sp1) pair for the requested lowering ("roll" | "slice")."""
    assert shift in ("roll", "slice")
    if shift == "slice":
        return _sm1_slice, _sp1_slice
    return _sm1, _sp1


def _band(shape, axis, lo, hi):
    i = lax.broadcasted_iota(jnp.int32, shape, axis)
    return (i >= lo) & (i <= hi)


class CanvasCoeffs3D(NamedTuple):
    """Chunk-invariant coefficient canvases (None ⇒ statically absent)."""

    c1: Optional[Array]          # pressure decay (None ⇒ 1, incompressible)
    c2: Optional[Array]          # pressure source (None ⇒ 0)
    c3: Array                    # pressure relaxation ψ·c1
    a_c: Array                   # normal-stress decay (scalar in viscous limit)
    b_c: Array                   # 2η·dτ_r at cells
    d_c: Optional[tuple]         # (dxx, dyy, dzz) elastic memory (None ⇒ 0)
    a_e: tuple                   # edge-family decay (yz, xz, xy)
    b_e: tuple                   # edge-family 2η_e·dτ_r
    d_e: Optional[tuple]         # edge elastic memory
    inv_eta: tuple               # ηdτ / face-averaged ητ (x, y, z)
    f: tuple                     # face-averaged body forces (x, y, z)


def _edge_avg(C, ax0, ax1):
    """Cell canvas -> edge-collocated 4-point average (v1-kernel formula:
    values land at the (ax0, ax1)-decremented canvas slots)."""
    e = 0.5 * (C + _sm1(C, ax0))
    return 0.5 * (e + _sm1(e, ax1))


def ve3d_canvas_coefficients(
    eta, eta_tau, r, theta_dtau, etadtau,
    fx=None, fy=None, fz=None,
    G=None, K=None, P0=None, Q=None, tau_o=None, dt=None,
    psi_eta=None,
) -> CanvasCoeffs3D:
    """Build the coefficient canvases from (nx, ny, nz) cell fields.

    ``G``/``K`` of ∞ (or None) select the viscous/incompressible limits with
    the corresponding coefficients statically removed from the iteration.
    ``psi_eta`` overrides the viscosity entering the pressure relaxation ψ
    (default ``eta_tau``; solve_ve_3d passes ``eta``, matching its
    compute_P call).
    """
    ni = eta.shape
    dtype = eta.dtype
    p1 = ((1, 1), (1, 1), (1, 1))

    def cell(A, mode="constant"):
        return jnp.pad(A, p1, mode=mode)

    zero = jnp.zeros(ni, dtype)
    fx = zero if fx is None else fx
    fy = zero if fy is None else fy
    fz = zero if fz is None else fz
    etat_c = cell(eta_tau, "edge")
    eta_c = cell(eta, "edge")
    inv_eta = tuple(
        etadtau / (0.5 * (etat_c + _sm1(etat_c, ax))) for ax in range(3)
    )
    f = tuple(
        0.5 * (c + _sm1(c, ax))
        for ax, c in enumerate((cell(fx, "edge"), cell(fy, "edge"), cell(fz, "edge")))
    )
    # edge collocations: τyz at (i+1, j, k) averages cells (j, j+1)×(k, k+1)
    # → roll axes (1, 2); τxz → (0, 2); τxy → (0, 1)
    edge_axes = ((1, 2), (0, 2), (0, 1))

    if psi_eta is None:
        psi_eta = eta_tau
    if G is None:
        dtau_r = 1.0 / (theta_dtau + 1.0)
        a_c = 1.0 - dtau_r
        b_c = cell(2.0 * eta * dtau_r, "edge")
        a_e = (a_c, a_c, a_c)
        b_e = tuple(2.0 * _edge_avg(eta_c, *ax) * dtau_r for ax in edge_axes)
        d_c = d_e = None
        psi = psi_eta * (r / theta_dtau)
        c1 = c2 = None
        c3 = cell(psi, "edge")
        if K is not None or P0 is not None or Q is not None:
            raise ValueError("compressible sources require G (use G=∞ array)")
        return CanvasCoeffs3D(c1, c2, c3, a_c, b_c, d_c, a_e, b_e, d_e,
                              inv_eta, f)

    # general VE / compressible form
    if dt is None:
        dt = jnp.inf
    K = jnp.full(ni, jnp.inf, dtype) if K is None else K
    P0 = zero if P0 is None else P0
    Q = zero if Q is None else Q
    if tau_o is None:
        tau_o = (zero, zero, zero,
                 jnp.zeros((ni[0], ni[1] + 1, ni[2] + 1), dtype),
                 jnp.zeros((ni[0] + 1, ni[1], ni[2] + 1), dtype),
                 jnp.zeros((ni[0] + 1, ni[1] + 1, ni[2]), dtype))
    txx_o, tyy_o, tzz_o, tyz_o, txz_o, txy_o = tau_o

    _Gdt = 1.0 / (G * dt)
    _Kdt = 1.0 / (K * dt)
    inv_dt = jnp.where(jnp.isinf(dt), 0.0, 1.0 / dt)
    psi = 1.0 / (1.0 / psi_eta + _Gdt) * (r / theta_dtau)
    c1v = 1.0 / (1.0 + _Kdt * psi)
    c2v = (P0 * _Kdt + Q * inv_dt) * psi * c1v
    c3 = cell(psi * c1v, "edge")
    c1 = cell(c1v, "edge")
    c2 = cell(c2v)
    dtau_r_c = 1.0 / (theta_dtau + eta * _Gdt + 1.0)
    a_c = cell(1.0 - dtau_r_c * (1.0 + eta * _Gdt), "edge")
    b_c = cell(2.0 * eta * dtau_r_c, "edge")
    coef = dtau_r_c * eta * _Gdt
    d_c = (cell(coef * txx_o), cell(coef * tyy_o), cell(coef * tzz_o))

    G_c = cell(G, "edge")
    a_e, b_e, d_e = [], [], []
    # interior-edge τ_o embedded at their canvas slots (zero elsewhere; the
    # boundary-edge rows are masked off in the iteration anyway)
    tyz_c = jnp.pad(tyz_o, ((1, 1), (0, 1), (0, 1)))
    txz_c = jnp.pad(txz_o, ((0, 1), (1, 1), (0, 1)))
    txy_c = jnp.pad(txy_o, ((0, 1), (0, 1), (1, 1)))
    for (ax0, ax1), to_c in zip(edge_axes, (tyz_c, txz_c, txy_c)):
        eta_e = _edge_avg(eta_c, ax0, ax1)
        _Gdt_e = 1.0 / (_edge_avg(G_c, ax0, ax1) * dt)
        dr_e = 1.0 / (theta_dtau + eta_e * _Gdt_e + 1.0)
        a_e.append(1.0 - dr_e * (1.0 + eta_e * _Gdt_e))
        b_e.append(2.0 * eta_e * dr_e)
        d_e.append(dr_e * eta_e * _Gdt_e * to_c)
    return CanvasCoeffs3D(c1, c2, c3, a_c, b_c, d_c,
                          tuple(a_e), tuple(b_e), tuple(d_e), inv_eta, f)


def iteration3d_canvas(carry, co: CanvasCoeffs3D, inv_di, *,
                       nx, ny, nz, free_slip=True, shift="slice"):
    """One fused 3D VE PT iteration on the 10 collocated canvases.

    Equivalent to compute_grad_V_3d → compute_P → compute_strain_rate_3d →
    compute_tau_ve_3d → compute_V_3d → flow_bcs(free-slip) on the staggered
    arrays (ops/stokes3d.py). ``shift`` picks the neighbor-shift lowering
    (see the comment above :func:`shift_fns`).
    """
    _sm1, _sp1 = shift_fns(shift)
    Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy = carry
    shape = P.shape
    inv_dx, inv_dy, inv_dz = inv_di
    third = 1.0 / 3.0

    def xb(lo, hi):
        return _band(shape, 0, lo, hi)

    def yb(lo, hi):
        return _band(shape, 1, lo, hi)

    def zb(lo, hi):
        return _band(shape, 2, lo, hi)

    Mc = xb(1, nx) & yb(1, ny) & zb(1, nz)
    Myz = xb(1, nx) & yb(1, ny - 1) & zb(1, nz - 1)
    Mxz = xb(1, nx - 1) & yb(1, ny) & zb(1, nz - 1)
    Mxy = xb(1, nx - 1) & yb(1, ny - 1) & zb(1, nz)
    MVx = xb(1, nx - 1) & yb(1, ny) & zb(1, nz)
    MVy = xb(1, nx) & yb(1, ny - 1) & zb(1, nz)
    MVz = xb(1, nx) & yb(1, ny) & zb(1, nz - 1)

    # divergence + pressure (coefficient form)
    dVxdx = (Vx - _sp1(Vx, 0)) * inv_dx
    dVydy = (Vy - _sp1(Vy, 1)) * inv_dy
    dVzdz = (Vz - _sp1(Vz, 2)) * inv_dz
    grad_V = dVxdx + dVydy + dVzdz
    P_new = P if co.c1 is None else P * co.c1
    if co.c2 is not None:
        P_new = P_new + co.c2
    P = jnp.where(Mc, P_new - grad_V * co.c3, P)

    # normal deviatoric strain + stress (cells)
    def upd_c(t, e, d):
        t_new = co.a_c * t + co.b_c * e
        return t_new if d is None else t_new + d

    dxx, dyy, dzz = co.d_c if co.d_c is not None else (None, None, None)
    txx = jnp.where(Mc, upd_c(txx, dVxdx - grad_V * third, dxx), txx)
    tyy = jnp.where(Mc, upd_c(tyy, dVydy - grad_V * third, dyy), tyy)
    tzz = jnp.where(Mc, upd_c(tzz, dVzdz - grad_V * third, dzz), tzz)

    # shear strain + stress (interior edges)
    eyz = 0.5 * ((_sm1(Vy, 2) - Vy) * inv_dz + (_sm1(Vz, 1) - Vz) * inv_dy)
    exz = 0.5 * ((_sm1(Vx, 2) - Vx) * inv_dz + (_sm1(Vz, 0) - Vz) * inv_dx)
    exy = 0.5 * ((_sm1(Vx, 1) - Vx) * inv_dy + (_sm1(Vy, 0) - Vy) * inv_dx)

    def upd_e(t, e, i):
        t_new = co.a_e[i] * t + co.b_e[i] * e
        return t_new if co.d_e is None else t_new + co.d_e[i]

    tyz = jnp.where(Myz, upd_e(tyz, eyz, 0), tyz)
    txz = jnp.where(Mxz, upd_e(txz, exz, 1), txz)
    txy = jnp.where(Mxy, upd_e(txy, exy, 2), txy)

    # damped velocity update on interior faces
    rx = (
        (_sm1(txx, 0) - txx) * inv_dx
        + (txy - _sp1(txy, 1)) * inv_dy
        + (txz - _sp1(txz, 2)) * inv_dz
        - (_sm1(P, 0) - P) * inv_dx
        - co.f[0]
    )
    Vx = jnp.where(MVx, Vx + rx * co.inv_eta[0], Vx)
    ry = (
        (txy - _sp1(txy, 0)) * inv_dx
        + (_sm1(tyy, 1) - tyy) * inv_dy
        + (tyz - _sp1(tyz, 2)) * inv_dz
        - (_sm1(P, 1) - P) * inv_dy
        - co.f[1]
    )
    Vy = jnp.where(MVy, Vy + ry * co.inv_eta[1], Vy)
    rz = (
        (txz - _sp1(txz, 0)) * inv_dx
        + (tyz - _sp1(tyz, 1)) * inv_dy
        + (_sm1(tzz, 2) - tzz) * inv_dz
        - (_sm1(P, 2) - P) * inv_dz
        - co.f[2]
    )
    Vz = jnp.where(MVz, Vz + rz * co.inv_eta[2], Vz)

    if free_slip:
        # tangential mirrors, serial .at[].set order (ops/bc.py: front, back,
        # top, bot, left, right) — proven against flow_bcs in
        # tests/test_stokes3d_canvas.py
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
    return (Vx, Vy, Vz, P, txx, tyy, tzz, tyz, txz, txy)


def stokes3d_chunk_canvas(carry, co: CanvasCoeffs3D, inv_di, nout, *,
                          free_slip=True, shift="slice"):
    """Advance ``nout`` fused canvas iterations under ``lax.fori_loop``.

    ``carry`` is the tuple of 10 canvases (``pack_carry`` layout unstacked);
    all coefficient canvases are loop-invariant. ``nout`` may be traced.
    """
    X = carry[3].shape
    nx, ny, nz = X[0] - 2, X[1] - 2, X[2] - 2

    def body(_, c):
        return iteration3d_canvas(
            c, co, inv_di, nx=nx, ny=ny, nz=nz, free_slip=free_slip,
            shift=shift,
        )

    return lax.fori_loop(0, nout, body, carry)


class LeanConsts3D(NamedTuple):
    """Minimal device-resident constants for the lean viscous canvas chunk.

    The precomputed viscous :class:`CanvasCoeffs3D` streams 11 coefficient
    canvases from device memory per iteration (c3, b_c, b_e×3, inv_eta×3,
    f×3). Here only the PHYSICS canvases are stored — ``eta``, ``eta_tau``,
    nonzero body-force cells — and every coefficient is re-derived inside
    the loop body (a handful of flops per cell for a memory-bound
    iteration).
    """

    eta: Array                    # cell canvas, edge-replicate padded
    eta_tau: Array                # maxloc(eta) cell canvas, edge padded
    f: tuple                      # per-axis body-force CELL canvas or None


def lean_canvas_consts(eta, eta_tau, fx=None, fy=None, fz=None
                       ) -> LeanConsts3D:
    """Build :class:`LeanConsts3D` from (nx, ny, nz) cell fields (viscous
    incompressible limit of :func:`ve3d_canvas_coefficients`)."""
    p1 = ((1, 1), (1, 1), (1, 1))
    f = tuple(None if c is None else jnp.pad(c, p1, mode="edge")
              for c in (fx, fy, fz))
    return LeanConsts3D(
        eta=jnp.pad(eta, p1, mode="edge"),
        eta_tau=jnp.pad(eta_tau, p1, mode="edge"),
        f=f,
    )


def _derive_coeffs_lean(lc: LeanConsts3D, P, r, theta_dtau, etadtau,
                        psi_from_eta=False) -> CanvasCoeffs3D:
    """Re-derive the viscous coefficient canvases INSIDE the loop body.

    XLA's WhileLoopInvariantCodeMotion would hoist these (loop-invariant)
    derivations out of the ``fori_loop`` and materialize them in device memory —
    silently restoring the precomputed path's traffic. The derivation is
    therefore threaded through a carry-dependent unit scalar ``s`` built
    from a NaN-sensitive self-comparison of the pressure canvas: XLA cannot
    prove ``P == P`` (NaN), so ``s`` — and everything derived from it —
    stays inside the body and fuses with its consumers. ``s == 1.0`` at
    runtime, and ``x * 1.0`` is exact, so results are bitwise identical to
    the precomputed-coefficient path (asserted in
    tests/test_stokes3d_canvas.py).
    """
    dtype = lc.eta.dtype
    p11 = P[1, 1, 1]
    s = jnp.where(p11 == p11, jnp.asarray(1.0, dtype), jnp.asarray(2.0, dtype))
    eta_c = lc.eta * s
    etat_c = lc.eta_tau * s
    dtau_r = 1.0 / (theta_dtau + 1.0)
    a_c = 1.0 - dtau_r
    b_c = 2.0 * eta_c * dtau_r
    edge_axes = ((1, 2), (0, 2), (0, 1))
    b_e = tuple(2.0 * _edge_avg(eta_c, *ax) * dtau_r for ax in edge_axes)
    inv_eta = tuple(
        etadtau / (0.5 * (etat_c + _sm1(etat_c, ax))) for ax in range(3)
    )
    psi_c = (eta_c if psi_from_eta else etat_c) * (r / theta_dtau)
    f = tuple(
        0.0 if c is None else 0.5 * (c * s + _sm1(c * s, ax))
        for ax, c in enumerate(lc.f)
    )
    return CanvasCoeffs3D(
        c1=None, c2=None, c3=psi_c, a_c=a_c, b_c=b_c, d_c=None,
        a_e=(a_c, a_c, a_c), b_e=b_e, d_e=None, inv_eta=inv_eta, f=f,
    )


def stokes3d_chunk_canvas_lean(carry, lc: LeanConsts3D, r, theta_dtau,
                               etadtau, inv_di, nout, *, free_slip=True,
                               psi_from_eta=False, shift="slice"):
    """Lean-consts variant of :func:`stokes3d_chunk_canvas`: identical
    physics, bitwise-equal results, ~3 constant canvases streamed per
    iteration instead of 11. ``r``/``theta_dtau``/``etadtau`` must be
    Python floats (static) so the scalar algebra matches the precomputed
    path bit for bit."""
    X = carry[3].shape
    nx, ny, nz = X[0] - 2, X[1] - 2, X[2] - 2

    def body(_, c):
        co = _derive_coeffs_lean(lc, c[3], r, theta_dtau, etadtau,
                                 psi_from_eta=psi_from_eta)
        return iteration3d_canvas(
            c, co, inv_di, nx=nx, ny=ny, nz=nz, free_slip=free_slip,
            shift=shift,
        )

    return lax.fori_loop(0, nout, body, carry)
