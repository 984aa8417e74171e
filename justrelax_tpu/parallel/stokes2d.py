"""Distributed (multi-device) APT visco-elastic Stokes solver, 2D.

The reference parallelizes by MPI domain decomposition with halo exchange
after every velocity / shear-stress / preconditioner update
(/root/reference/src/stokes/Stokes2D.jl:181-341 + ImplicitGlobalGrid). The
JAX-native re-design runs the whole PT loop inside one ``shard_map`` over an
("x","y") device mesh:

- per-device state is the blocked-local staggered layout of decomp.py
  (disjoint cell ownership; velocities carry shared faces + ghost rows);
- neighbor center values arrive as ghost extensions (``halo.extend`` →
  ``lax.ppermute``) of the fields that change each iteration (P, τxx, τyy);
- shared faces and vertices are computed redundantly by both neighbors from
  identical ghost-extended inputs ("compute in halo"), so only the velocity
  ghost *rows* need a post-update exchange — fewer syncs than the reference's
  three `update_halo!` calls;
- physical boundary conditions and convergence norms use
  ``lax.axis_index``-derived masks; norms are ``lax.psum`` reductions, so the
  convergence control runs entirely on device (reference: MPI.Allreduce).

Single-device results are reproduced exactly (see tests/test_distributed.py).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from justrelax_tpu.core.coeffs import PTStokesCoeffs
from justrelax_tpu.ops import stokes as kernels
from justrelax_tpu.ops.bc import Faces, VelocityBoundaryConditions
from justrelax_tpu.ops.stencil import av_a, interior_add, interior_set, maxloc
from justrelax_tpu.parallel import halo
from justrelax_tpu.parallel.decomp import Decomp2D

Array = Any

__all__ = ["solve_ve_sharded"]


class ShardedSolveResult(NamedTuple):
    Vx: Array
    Vy: Array
    P: Array
    txx: Array
    tyy: Array
    txy: Array
    err: Array
    iters: Array


def _flow_bcs_local(Vx, Vy, bc: VelocityBoundaryConditions, fx, lx_, fy, ly_):
    """Physical-boundary-masked velocity BCs (free_slip / no_slip)."""
    fs, ns = bc.free_slip, bc.no_slip
    if Faces.on(ns.left):
        Vx = Vx.at[0, :].set(jnp.where(fx, 0.0, Vx[0, :]))
        Vy = Vy.at[0, :].set(jnp.where(fx, -Vy[1, :], Vy[0, :]))
    if Faces.on(ns.right):
        Vx = Vx.at[-1, :].set(jnp.where(lx_, 0.0, Vx[-1, :]))
        Vy = Vy.at[-1, :].set(jnp.where(lx_, -Vy[-2, :], Vy[-1, :]))
    if Faces.on(ns.bot):
        Vx = Vx.at[:, 1].set(jnp.where(fy, Vx[:, 2] / 3.0, Vx[:, 1]))
        Vx = Vx.at[:, 0].set(jnp.where(fy, -Vx[:, 1], Vx[:, 0]))
        Vy = Vy.at[:, 0].set(jnp.where(fy, 0.0, Vy[:, 0]))
    if Faces.on(ns.top):
        Vx = Vx.at[:, -1].set(jnp.where(ly_, -Vx[:, -2], Vx[:, -1]))
        Vy = Vy.at[:, -1].set(jnp.where(ly_, 0.0, Vy[:, -1]))
    if Faces.on(fs.bot):
        Vx = Vx.at[:, 0].set(jnp.where(fy, Vx[:, 1], Vx[:, 0]))
    if Faces.on(fs.top):
        Vx = Vx.at[:, -1].set(jnp.where(ly_, Vx[:, -2], Vx[:, -1]))
    if Faces.on(fs.left):
        Vy = Vy.at[0, :].set(jnp.where(fx, Vy[1, :], Vy[0, :]))
    if Faces.on(fs.right):
        Vy = Vy.at[-1, :].set(jnp.where(lx_, Vy[-2, :], Vy[-1, :]))
    return Vx, Vy


def momentum_all_faces(Pr, txx, tyy, txy_v, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy):
    """Momentum residuals on ALL local faces (compute-in-halo form).

    Ghost-extends the center fields that the face stencils straddle and
    evaluates the SAME ``ops/stokes.py`` momentum kernels as the serial
    solver — their shape-driven τxy alignment selects the all-faces form.
    ``rho_gx_ex``/``rho_gy_ey`` arrive pre-extended (loop-invariant in the VE
    solve; recomputed per iteration by the VEP solver).
    """
    P_ex = halo.extend(Pr, 0, 1)
    txx_ex = halo.extend(txx, 0, 1)
    Rx = kernels._x_momentum(P_ex, txx_ex, txy_v, rho_gx_ex, inv_dx, inv_dy)
    P_ey = halo.extend(Pr, 1, 1)
    tyy_ey = halo.extend(tyy, 1, 1)
    Ry = kernels._y_momentum(P_ey, tyy_ey, txy_v, rho_gy_ey, inv_dx, inv_dy)
    return Rx, Ry


def _freeze_rows(A, new, axis, lo_mask, hi_mask):
    """Keep A's outermost slices along axis where the device sits on the
    physical boundary (serial kernels never write global-boundary nodes)."""
    s = new.shape[axis]
    lo_new = lax.slice_in_dim(new, 0, 1, axis=axis)
    lo_old = lax.slice_in_dim(A, 0, 1, axis=axis)
    hi_new = lax.slice_in_dim(new, s - 1, s, axis=axis)
    hi_old = lax.slice_in_dim(A, s - 1, s, axis=axis)
    mid = lax.slice_in_dim(new, 1, s - 1, axis=axis)
    lo = jnp.where(lo_mask, lo_old, lo_new)
    hi = jnp.where(hi_mask, hi_old, hi_new)
    return jnp.concatenate([lo, mid, hi], axis=axis)


def solve_ve_sharded(
    mesh,
    decomp: Decomp2D,
    blocks: dict,
    pt_stokes: PTStokesCoeffs,
    flow_bc: VelocityBoundaryConditions,
    dt,
    iter_max: int = 10_000,
    nout: int = 500,
    overlap: bool = True,
):
    """Run the VE APT Stokes solve over the mesh. ``blocks`` holds the
    blocked-local container arrays: Vx, Vy, P, P0, Q, txx, tyy, txy,
    txx_o, tyy_o, txy_o, eta, G, K, rho_gx, rho_gy.

    ``overlap=True`` is the analogue of the reference's
    ``@hide_communication`` (src/stokes/Stokes2D.jl:768-785): the velocity
    ghost rows received by ``ppermute`` are carried as *separate* slices
    instead of being concatenated back into V at the end of each iteration.
    Concatenation would make the next iteration's first op depend on the
    collective; with split carries, the only true consumer of the ghosts is
    the shear strain rate at block-edge vertices, so XLA's latency-hiding
    scheduler is free to overlap the halo collective-permute with the whole
    interior divergence/pressure/normal-stress chain of the next iteration.
    Both paths are bit-identical (tests/test_distributed.py).

    Returns a :class:`ShardedSolveResult` of blocked-local containers.
    """
    nxl, nyl = decomp.ni_local
    nx_g, ny_g = decomp.ni_global
    # geometry: uniform grid; spacing from global extent implied by caller
    inv_dx, inv_dy = blocks.pop("inv_dx"), blocks.pop("inv_dy")
    r, theta, etadtau = pt_stokes.r, pt_stokes.theta_dtau, pt_stokes.etadtau
    eps_rel, eps_abs = pt_stokes.eps_rel, pt_stokes.eps_abs
    nout_i = int(nout)
    max_chunks = max(1, int(math.ceil(iter_max / nout_i)))

    def local_solve(Vx, Vy, Pr, P0, Q, txx, tyy, txy, txx_o, tyy_o, txy_o,
                    eta, G, K, rho_gx, rho_gy):
        fx, lx_ = halo.axis_edges("x")
        fy, ly_ = halo.axis_edges("y")
        rx = lax.axis_index("x")
        ry = lax.axis_index("y")

        # --- static (per-solve) ghost extensions ---------------------------
        eta_e2 = halo.extend(halo.extend(eta, 0, 2), 1, 2)
        eta_tau_full = maxloc(eta_e2, window=1)[1:-1, 1:-1]  # (nxl+2, nyl+2)
        eta_tau = eta_tau_full[1:-1, 1:-1]
        eta_e1 = halo.extend(halo.extend(eta, 0, 1), 1, 1)
        G_e1 = halo.extend(halo.extend(G, 0, 1), 1, 1)
        eta_v = av_a(eta_e1)  # all local vertices (nxl+1, nyl+1)
        G_v = av_a(G_e1)
        rho_gx_ex = halo.extend(rho_gx, 0, 1)  # (nxl+2, nyl)
        rho_gy_ey = halo.extend(rho_gy, 1, 1)  # (nxl, nyl+2)
        etat_x = eta_tau_full[:, 1:-1]  # (nxl+2, nyl)
        etat_y = eta_tau_full[1:-1, :]  # (nxl, nyl+2)

        def eff_ghosts(Vx, Vy, gxl, gxh, gyl, gyh):
            """Assemble the ghost-refreshed V arrays from split carries.

            Physical-boundary devices keep their own (BC-determined) ghost
            rows; interior devices take the carried ppermute slices. Values
            are bit-identical to ``exchange_ghosts``."""
            Vx_f = jnp.concatenate(
                [
                    jnp.where(fy, Vx[:, 0:1], gxl),
                    Vx[:, 1:-1],
                    jnp.where(ly_, Vx[:, -1:], gxh),
                ],
                axis=1,
            )
            Vy_f = jnp.concatenate(
                [
                    jnp.where(fx, Vy[0:1, :], gyl),
                    Vy[1:-1, :],
                    jnp.where(lx_, Vy[-1:, :], gyh),
                ],
                axis=0,
            )
            return Vx_f, Vy_f

        def one_iteration(_, c):
            if overlap:
                Vx, Vy, Pr, txx, tyy, txy, gxl, gxh, gyl, gyh = c
                # the ONLY consumer of the halo ghosts is the edge-vertex
                # shear strain rate below — grad_V/P/normal-stress are free
                # to overlap with the (previous iteration's) ppermutes
                Vx_f, Vy_f = eff_ghosts(Vx, Vy, gxl, gxh, gyl, gyh)
            else:
                Vx, Vy, Pr, txx, tyy, txy = c
                Vx_f, Vy_f = Vx, Vy
            # divergence + pressure + strain rate: the serial kernels verbatim
            # (Vx_f/Vy_f differ from Vx/Vy only in ghost rows, which the
            # center stencils never read; εxy lands on every local vertex)
            grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            _, Pr = kernels.compute_P(
                Pr, P0, grad_V, Q, eta_tau, K, G, dt, r, theta
            )
            exx, eyy, exy = kernels.compute_strain_rate(
                grad_V, Vx_f, Vy_f, inv_dx, inv_dy
            )

            # stress update: centers local; the ghost-built eta_v/G_v select
            # the all-vertices form, then physical-boundary vertices are
            # frozen (the serial kernel never writes them)
            txx, tyy, txy_new = kernels.compute_tau_ve(
                txx, tyy, txy, txx_o, tyy_o, txy_o, exx, eyy, exy,
                eta, G, theta, dt, eta_v=eta_v, G_v=G_v,
            )
            txy_new = _freeze_rows(txy, txy_new, 0, fx, lx_)
            txy_new = _freeze_rows(txy, txy_new, 1, fy, ly_)
            txy = txy_new

            # velocity update on ALL local faces from ghost-extended inputs
            rx_mom, ry_mom = momentum_all_faces(
                Pr, txx, tyy, txy, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy
            )
            etax = 0.5 * (etat_x[1:, :] + etat_x[:-1, :])
            etay = 0.5 * (etat_y[:, 1:] + etat_y[:, :-1])
            Vx_new = interior_add(Vx, rx_mom * etadtau / etax, pads=((0, 0), (1, 1)))
            Vy_new = interior_add(Vy, ry_mom * etadtau / etay, pads=((1, 1), (0, 0)))
            Vx = _freeze_rows(Vx, Vx_new, 0, fx, lx_)
            Vy = _freeze_rows(Vy, Vy_new, 1, fy, ly_)

            # physical BCs + ghost-row exchange
            Vx, Vy = _flow_bcs_local(Vx, Vy, flow_bc, fx, lx_, fy, ly_)
            if overlap:
                # issue the halo permutes but carry the received slices
                # separately (@hide_communication analogue — no concat back
                # into V, so the collective has the whole next-iteration
                # interior chain to hide behind)
                gxl = halo.from_prev(Vx[:, nyl:nyl + 1], "y")
                gxh = halo.from_next(Vx[:, 1:2], "y")
                gyl = halo.from_prev(Vy[nxl:nxl + 1, :], "x")
                gyh = halo.from_next(Vy[1:2, :], "x")
                return (Vx, Vy, Pr, txx, tyy, txy, gxl, gxh, gyl, gyh)
            Vx = halo.exchange_ghosts(Vx, 1, nyl)
            Vy = halo.exchange_ghosts(Vy, 0, nxl)
            return (Vx, Vy, Pr, txx, tyy, txy)

        def residual_norms(Vx, Vy, Pr, txx, tyy, txy):
            grad_V = kernels.compute_grad_V(Vx, Vy, inv_dx, inv_dy)
            RP, _ = kernels.compute_P(
                Pr, P0, grad_V, Q, eta_tau, K, G, dt, r, theta
            )
            Rx, Ry = momentum_all_faces(
                Pr, txx, tyy, txy, rho_gx_ex, rho_gy_ey, inv_dx, inv_dy
            )
            # ownership + reference norm-window masks (Rx[1:-1,1:-1] global)
            gfx = rx * nxl + jnp.arange(nxl + 1)  # global face idx of Rx rows
            gcy = ry * nyl + jnp.arange(nyl)  # global cell idx of Rx cols
            own_x = jnp.arange(nxl + 1) >= 1
            mx = (own_x & (gfx >= 2) & (gfx <= nx_g - 2))[:, None] & (
                (gcy >= 1) & (gcy <= ny_g - 2)
            )[None, :]
            gcx = rx * nxl + jnp.arange(nxl)
            gfy = ry * nyl + jnp.arange(nyl + 1)
            own_y = jnp.arange(nyl + 1) >= 1
            my = ((gcx >= 1) & (gcx <= nx_g - 2))[:, None] & (
                own_y & (gfy >= 2) & (gfy <= ny_g - 2)
            )[None, :]
            ss_x = lax.psum(jnp.sum(jnp.where(mx, Rx, 0.0) ** 2), ("x", "y"))
            ss_y = lax.psum(jnp.sum(jnp.where(my, Ry, 0.0) ** 2), ("x", "y"))
            ss_p = lax.psum(jnp.sum(RP**2), ("x", "y"))
            nRx = jnp.sqrt(ss_x) / math.sqrt((nx_g - 2) * (ny_g - 1))
            nRy = jnp.sqrt(ss_y) / math.sqrt((nx_g - 1) * (ny_g - 2))
            nRP = jnp.sqrt(ss_p) / math.sqrt(nx_g * ny_g)
            return nRx, nRy, nRP

        def cond(c):
            _, err, err1, chunk = c
            not_conv = ((err / err1) > eps_rel) & (err > eps_abs)
            return (chunk < 1) | (not_conv & (chunk < max_chunks))

        def body(c):
            state, err, err1, chunk = c
            state = lax.fori_loop(0, nout_i, one_iteration, state)
            nRx, nRy, nRP = residual_norms(*state[:6])
            err = jnp.maximum(jnp.maximum(nRx, nRy), nRP)
            err1 = jnp.where(chunk == 0, err, err1)
            return state, err, err1, chunk + 1

        dtype = Pr.dtype
        state0 = (Vx, Vy, Pr, txx, tyy, txy)
        if overlap:
            # initial ghost carries = the containers' current ghost rows
            # (bit-matching the non-overlap path's first-iteration reads)
            state0 = state0 + (Vx[:, 0:1], Vx[:, -1:], Vy[0:1, :], Vy[-1:, :])
        init = (
            state0,
            jnp.asarray(jnp.inf, dtype),
            jnp.asarray(1.0, dtype),
            jnp.asarray(0, jnp.int32),
        )
        state, err, _, chunk = lax.while_loop(cond, body, init)
        Vx, Vy, Pr, txx, tyy, txy = state[:6]
        if overlap:
            # materialize the carried ghost slices back into V so the
            # returned containers match the exchange_ghosts layout
            Vx, Vy = eff_ghosts(Vx, Vy, *state[6:])
        return ShardedSolveResult(
            Vx=Vx, Vy=Vy, P=Pr, txx=txx, tyy=tyy, txy=txy,
            err=err, iters=chunk * nout_i,
        )

    spec = P("x", "y")
    in_specs = (spec,) * 16
    out_specs = ShardedSolveResult(
        Vx=spec, Vy=spec, P=spec, txx=spec, tyy=spec, txy=spec,
        err=P(), iters=P(),
    )
    fn = jax.shard_map(
        local_solve, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    order = (
        "Vx", "Vy", "P", "P0", "Q", "txx", "tyy", "txy",
        "txx_o", "tyy_o", "txy_o", "eta", "G", "K", "rho_gx", "rho_gy",
    )
    return fn(*(blocks[k] for k in order))
