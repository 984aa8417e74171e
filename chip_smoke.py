#!/usr/bin/env python3
"""Drive the APT solvers once on the GPU, through the entry points a user
calls, at deployment size, and check what comes out.

    python chip_smoke.py             # one card: phases 0-5 below
    python chip_smoke.py --cards 4   # four cards: sharded 2D and 3D VEP
                                     # against their serial twins, only

One card, in order (each phase prints its own ``[phase] {...}`` lines):

0. device       the default device must be a GPU; card name and power limit
                from nvidia-smi; the compile-cache directory.
1. goldens      small solves against the reference's oracles, f64 and f32
                (justrelax_tpu/utils/goldens.py).
2. shearband2d  models.shearband.run at 1024² f64, 3 converged steps; then
                200 fixed PT iterations at 4096² f64 on the card and on the
                host CPU (the reference), compared field by field.
3. shearband3d  models.shearband3d.run at 128³ f64, 2 converged steps; then
                the card-vs-host check at 256³ with 100 iterations.
4. coupled      models.blankenbach.run_particles (Stokes, thermal, RK2
                particle advection, P2G/G2P): 32² against the reference's
                oracles, then 256² for 3 steps.
5. xla_passes   per-iteration time of each XLA bench family at 4096² / 256³
                f32, its stream rate and its share of a copy rate measured
                in the same run. Findings, not checks.

The host references of phases 2 and 3 are dispatched right after phase 0 and
computed on the CPU while the card works; phases 2 and 3 wait for them.

Any failed check or error stops the run with a non-zero exit and no
``"ok": true`` line. On success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Everything runs in this one process: one JAX process per card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from justrelax_tpu.utils import device

# card-vs-host bound: max |card - host| over max |host|, per field. Both run
# the same f64 program; they differ only in summation order and fused
# multiply-adds, ~1e-16 per operation.
HOST_RTOL = 1.0e-9


def log(phase, **rec):
    print(f"[{phase}] " + json.dumps(rec, default=_jsonable), flush=True)


def _jsonable(x):
    if isinstance(x, (np.generic, jax.Array)):
        return np.asarray(x).tolist()
    return str(x)


class PhaseFailure(AssertionError):
    """A check of a phase did not hold."""


def check(ok, what):
    if not ok:
        raise PhaseFailure(what)


def stokes_converged(info, pt) -> bool:
    """The solver's own stopping rule: absolute residual below ``eps_abs``
    or relative to the first chunk's below ``eps_rel``."""
    err = float(info.err)
    err1 = float(np.asarray(info.err_history)[0])
    return bool(np.isfinite(err)
                and (err <= pt.eps_abs or err <= pt.eps_rel * err1))


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class Lap:
    """Seconds since the last lap, split by a :class:`CompileClock` into
    compile time and the rest: ``lap()`` returns ``(compile_s, run_s)``."""

    def __init__(self, clock):
        self.clock = clock
        self.t, self.c = time.perf_counter(), clock.seconds

    def lap(self):
        now, comp = time.perf_counter(), self.clock.seconds
        compile_s = comp - self.c
        run_s = now - self.t - compile_s
        self.t, self.c = now, comp
        return compile_s, run_s


def rel_diffs(pairs):
    """``max|a - b| / max|b|`` for each ``name: (a, b)``."""
    rel = {}
    for name, (a, b) in pairs.items():
        a, b = np.asarray(a), np.asarray(b)
        scale = float(np.abs(b).max())
        diff = float(np.abs(a - b).max())
        rel[name] = diff / scale if scale > 0 else diff
    return rel


def check_rel(what, rel):
    worst = max(rel, key=rel.get)
    check(rel[worst] <= HOST_RTOL,
          f"{what}: {worst} differs by {rel[worst]:.3e} > {HOST_RTOL}")


# --------------------------------------------------------------------------
# phase 0
# --------------------------------------------------------------------------
def phase_device(cards=1):
    dev = device.require_gpu()
    count = len(jax.devices())
    check(count >= cards, f"{cards} cards requested, JAX sees {count}")
    smi = device.nvidia_smi()
    cards_smi = device.parse_nvidia_smi(smi)
    log("device", platform=dev.platform, kind=dev.device_kind, count=count,
        jax=jax.__version__, nvidia_smi=cards_smi,
        compile_cache=jax.config.jax_compilation_cache_dir)
    return smi


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def phase_goldens(names=None, dtypes=None):
    from justrelax_tpu.utils.goldens import DTYPES, GOLDENS, run_golden

    failed = []
    for name in names or GOLDENS:
        for dtype in dtypes or DTYPES:
            t0 = time.perf_counter()
            res = run_golden(name, dtype)
            log("goldens", name=name, dtype=dtype,
                seconds=time.perf_counter() - t0, **res)
            if not res["pass"]:
                failed.append(f"{name}/{dtype}")
    check(not failed, f"goldens failed: {failed}")


# --------------------------------------------------------------------------
# phases 2 and 3: converged steps, and the card-vs-host check
# --------------------------------------------------------------------------
def run_steps(phase, run, n, nt, tau_y, compile_clock):
    """Run ``run(n=n, nt=nt, on_step=...)`` (a model's time loop) and print
    each step: iterations, final residual, wall time ending in
    ``block_until_ready`` and compile seconds, kept apart. Every solve must
    converge and keep max τII below twice the yield stress."""
    steps = []
    lap = Lap(compile_clock)

    def on_step(stokes, info, pt, **_):
        jax.block_until_ready(stokes)
        compile_s, run_s = lap.lap()
        rec = dict(step=len(steps), n=n, iters=int(info.iters),
                   err=float(info.err), converged=stokes_converged(info, pt),
                   tauII_max=float(jnp.max(stokes.tau.II)),
                   compile_s=compile_s, run_s=run_s)
        log(phase, **rec)
        steps.append(rec)
        lap.lap()  # the model's own bookkeeping is not the next step's

    run(n=n, nt=nt, on_step=on_step)
    check(len(steps) == nt, f"{len(steps)} of {nt} steps ran")
    bad = [s["step"] for s in steps if not s["converged"]]
    check(not bad, f"steps {bad} stopped above their tolerance")
    top = max(s["tauII_max"] for s in steps)
    check(top < 2.0 * tau_y, f"max tauII {top} >= 2 tau_y = {2 * tau_y}")
    return steps


class HostReference:
    """The same fixed-iteration solve dispatched on the host CPU. JAX runs
    it asynchronously, so the card keeps working meanwhile; :meth:`result`
    waits for it."""

    def __init__(self, solve, args, iters):
        cpu = jax.devices("cpu")[0]
        self.kw = dict(iter_max=iters, iter_min=iters, nout=min(iters, 100))
        host_args = jax.tree.map(
            lambda x: jax.device_put(x, cpu) if isinstance(x, jax.Array)
            else x, args)
        with jax.default_device(cpu):
            self.out, self.info = solve(*host_args, **self.kw)

    def result(self):
        return jax.block_until_ready((self.out, self.info))


def compare_card_host(phase, solve, args, host, fields, compile_clock):
    """Run ``solve`` on the card with the host reference's fixed iteration
    count from the same state and hold every field to
    ``max|card - host| / max|host| <= HOST_RTOL``."""
    lap = Lap(compile_clock)
    out, info = jax.block_until_ready(solve(*args, **host.kw))
    compile_s, run_s = lap.lap()
    ref, ref_info = host.result()
    _, wait_s = lap.lap()
    check(int(info.iters) == int(ref_info.iters) == host.kw["iter_max"],
          f"iterations card {int(info.iters)} host {int(ref_info.iters)}")
    rel = rel_diffs({k: (get(out), get(ref)) for k, get in fields.items()})
    yielded = int(np.count_nonzero(np.asarray(ref.lam) > 0))
    log(phase, check="card_vs_host", cells=int(np.prod(ref.P.shape)),
        iters=int(info.iters), card_run_s=run_s, card_compile_s=compile_s,
        host_wait_s=wait_s, yielding_cells=yielded, rel_diff=rel,
        bound=HOST_RTOL, peak_bytes_in_use=peak_bytes())
    check_rel("card vs host", rel)
    return rel


FIELDS_2D = {
    "Vx": lambda s: s.V.Vx, "Vy": lambda s: s.V.Vy, "P": lambda s: s.P,
    "txx": lambda s: s.tau.xx, "tyy": lambda s: s.tau.yy,
    "txy": lambda s: s.tau.xy, "txy_c": lambda s: s.tau.xy_c,
}
FIELDS_3D = {
    "Vx": lambda s: s.V.Vx, "Vy": lambda s: s.V.Vy, "Vz": lambda s: s.V.Vz,
    "P": lambda s: s.P,
    "txx": lambda s: s.tau.xx, "tyy": lambda s: s.tau.yy,
    "tzz": lambda s: s.tau.zz, "tyz": lambda s: s.tau.yz,
    "txz": lambda s: s.tau.xz, "txy": lambda s: s.tau.xy,
}


def start_host_2d(n=4096, iters=200):
    from justrelax_tpu.models import shearband
    from justrelax_tpu.solvers.stokes2d_vep import solve_vep

    args = shearband.setup(n)
    return args, HostReference(solve_vep, args, iters)


def start_host_3d(n=256, iters=100):
    from justrelax_tpu.models import shearband3d
    from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d

    args = shearband3d.setup(n)
    return args, HostReference(solve_vep_3d, args, iters)


def phase_shearband2d(host, n=1024, nt=3, compile_clock=None):
    from justrelax_tpu.models import shearband
    from justrelax_tpu.solvers.stokes2d_vep import solve_vep

    run_steps("shearband2d", shearband.run, n, nt, 1.6, compile_clock)
    args, ref = host
    compare_card_host("shearband2d", solve_vep, args, ref, FIELDS_2D,
                      compile_clock)


def phase_shearband3d(host, n=128, nt=2, compile_clock=None):
    from justrelax_tpu.models import shearband3d
    from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d

    run_steps("shearband3d", shearband3d.run, n, nt, 1.6, compile_clock)
    args = shearband3d.setup(n)
    compiled = solve_vep_3d.lower(
        *args, iter_max=30_000, iter_min=100, nout=200,
        viscosity_relaxation=1.0).compile()
    log("shearband3d", n=n, memory_analysis=str(compiled.memory_analysis()),
        peak_bytes_in_use=peak_bytes())
    args, ref = host
    compare_card_host("shearband3d", solve_vep_3d, args, ref, FIELDS_3D,
                      compile_clock)


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------
# tests/test_blankenbach.py::test_blankenbach_particles: the reference's
# Urms and Nu (test_Blankenbach.jl:283-288); Urms at rtol 2e-1 because
# bilinear PIC damps the plume spin-up at 32². Particle scatters sum with
# atomics in an order that changes from run to run; the last bits of the
# gridded temperature move, far inside these tolerances.
URMS_REF, NU_REF = 0.40987052065118357, 1.0026242251320245


def _coupled_run(n, nt, compile_clock):
    """``blankenbach.run_particles`` at ``n``² for ``nt`` steps, printing
    each step. Returns the run's output and the per-step records."""
    from justrelax_tpu.models import blankenbach

    steps = []
    lap = Lap(compile_clock)

    def on_step(stokes, info, pt, thermal, thermal_info, pt_thermal):
        jax.block_until_ready((stokes, thermal))
        compile_s, run_s = lap.lap()
        finite = all(bool(jnp.isfinite(a).all()) for a in (
            stokes.V.Vx, stokes.V.Vy, stokes.P, thermal.T))
        rec = dict(n=n, step=len(steps), iters=int(info.iters),
                   err=float(info.err),
                   converged=stokes_converged(info, pt),
                   thermal_iters=int(thermal_info.iters),
                   thermal_err=float(thermal_info.err),
                   thermal_converged=bool(
                       float(thermal_info.err) <= pt_thermal.eps),
                   finite=finite, compile_s=compile_s, run_s=run_s)
        log("coupled", **rec)
        steps.append(rec)
        lap.lap()

    out = blankenbach.run_particles(nx=n, ny=n, nit=nt, on_step=on_step)
    return out, steps


def coupled_oracles(n=32, nit=10, compile_clock=None):
    (urms, nu, info, _, _), _ = _coupled_run(n, nit, compile_clock)
    log("coupled", n=n, Urms=urms[-1], Urms_ref=URMS_REF,
        Nu=nu[-1], Nu_ref=NU_REF)
    check(float(info.err) < 1.0e-4, f"residual {float(info.err)}")
    check(abs(urms[-1] - URMS_REF) <= 2.0e-1 * URMS_REF,
          f"Urms {urms[-1]} vs {URMS_REF} (rtol 2e-1)")
    check(abs(nu[-1] - NU_REF) <= 1.0e-2 * NU_REF,
          f"Nu {nu[-1]} vs {NU_REF} (rtol 1e-2)")
    check(urms[-1] > urms[2] > 0.0, "Urms spin-up not monotone")


def coupled_steps(n=256, nt=3, compile_clock=None):
    _, steps = _coupled_run(n, nt, compile_clock)
    bad = [s["step"] for s in steps
           if not (s["converged"] and s["thermal_converged"] and s["finite"])]
    check(len(steps) == nt and not bad,
          f"{n}²: steps {bad} did not converge or are not finite")


def phase_coupled(compile_clock):
    coupled_oracles(compile_clock=compile_clock)
    coupled_steps(compile_clock=compile_clock)


# --------------------------------------------------------------------------
# phase 5
# --------------------------------------------------------------------------
def xla_pass_families(n2d=4096, n3d=256):
    """(label, family, factory kwargs) of every XLA bench family, and the 3D
    VEP iteration once more with only its center or only its edge passes."""
    f32 = jnp.float32
    two = dict(dtype=f32)
    out = [("ve2d", "ve2d", dict(nx=n2d, ny=n2d, **two)),
           ("vep2d", "vep2d", dict(n=n2d, **two)),
           ("thermal2d", "thermal2d", dict(nx=n2d, ny=n2d, **two))]
    for fam in ("ve3d", "ve3d_canvas", "vep3d", "vep3d_canvas"):
        out.append((fam, fam, dict(n=n3d, **two)))
    for part in ("center", "edges"):
        out.append((f"vep3d[{part}]", "vep3d",
                    dict(n=n3d, probe_passes=(part,), **two)))
    return out


def phase_xla_passes(n2d=4096, n3d=256, copy_bytes=1 << 30,
                     target_s=0.3):
    from justrelax_tpu.utils.bench_kernels import measure_family
    from justrelax_tpu.utils.timing import copy_rate

    with jax.enable_x64(False):
        copy_Bs = copy_rate(copy_bytes)
        log("xla_passes", copy_GBs=copy_Bs / 1e9, copy_bytes=copy_bytes)
        for label, fam, kw in xla_pass_families(n2d, n3d):
            log("xla_passes", family=label,
                **measure_family(fam, copy_Bs, target_s=target_s, **kw))


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------
def _hlo_permutes(hlo_text):
    """Counts of halo collective-permutes in compiled HLO, by form."""
    ops = re.findall(r"\b(collective-permute(?:-start|-done)?)\(", hlo_text)
    return {k: ops.count(k) for k in
            ("collective-permute", "collective-permute-start",
             "collective-permute-done")}


def _sharded_run(phase, solve_sharded, mesh, dec, blocks, statics, iters,
                 compile_clock):
    arrays = {k: v for k, v in blocks.items() if not k.startswith("inv_d")}
    scalars = {k: v for k, v in blocks.items() if k.startswith("inv_d")}
    fn = jax.jit(lambda arr: solve_sharded(
        mesh, dec, {**arr, **scalars}, *statics, iter_max=iters,
        iter_min=iters, nout=min(iters, 100)))
    lap = Lap(compile_clock)
    compiled = fn.lower(arrays).compile()
    compile_s, _ = lap.lap()
    permutes = _hlo_permutes(compiled.as_text())
    jax.block_until_ready(compiled(arrays))  # first execution
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(arrays))
    t_iter = (time.perf_counter() - t0) / iters
    all_async = (permutes["collective-permute"] == 0
                 and permutes["collective-permute-start"]
                 == permutes["collective-permute-done"] > 0)
    log(phase, check="sharded", compile_s=compile_s, t_iter_us=t_iter * 1e6,
        collective_permutes=permutes, all_halo_permutes_async=all_async)
    return res


def _serial_run(phase, solve, args, iters, compile_clock):
    kw = dict(iter_max=iters, iter_min=iters, nout=min(iters, 100))
    lap = Lap(compile_clock)
    jax.block_until_ready(solve(*args, **kw))  # compile + first execution
    compile_s, _ = lap.lap()
    t0 = time.perf_counter()
    out, info = jax.block_until_ready(solve(*args, **kw))
    t_iter = (time.perf_counter() - t0) / iters
    check(int(info.iters) == iters, f"serial ran {int(info.iters)} iterations")
    log(phase, check="serial", compile_s=compile_s, t_iter_us=t_iter * 1e6)
    return out


def _compare(phase, pairs):
    rel = rel_diffs(pairs)
    log(phase, check="sharded_vs_serial", rel_diff=rel, bound=HOST_RTOL)
    check_rel("sharded vs serial", rel)


def four_cards_2d(n=4096, iters=200, mesh_shape=(2, 2), compile_clock=None):
    """Sharded 2D VEP (parallel/stokes2d_vep.solve_vep_sharded) on a 2×2
    mesh against serial ``solve_vep`` of the same global problem on one
    card."""
    from justrelax_tpu.models import shearband
    from justrelax_tpu.parallel.decomp import (
        Decomp2D,
        block_staggered,
        block_staggered_nd,
        unblock_staggered,
    )
    from justrelax_tpu.parallel.stokes2d_vep import solve_vep_sharded
    from justrelax_tpu.solvers.stokes2d_vep import solve_vep

    phase = "four_cards_2d"
    args = shearband.setup(n)
    st, pt, geometry, bc, mat, pr_c, pr_v, dt = args
    ref = _serial_run(phase, solve_vep, args, iters, compile_clock)

    devs = np.array(jax.devices()[:4]).reshape(mesh_shape)
    mesh = jax.sharding.Mesh(devs, ("x", "y"))
    dec = Decomp2D.make((n, n), mesh_shape)
    extras = {"Vx": (1, 2), "Vy": (2, 1), "txy_v": (1, 1), "eta_v": (1, 1)}

    def B(key, A):
        return block_staggered(np.asarray(A), dec, extras.get(key, (0, 0)))

    t, to = st.tau, st.tau_o
    host = {
        "Vx": st.V.Vx, "Vy": st.V.Vy, "P": st.P, "Q": st.Q,
        "txx": t.xx, "tyy": t.yy, "txy_c": t.xy_c, "txy_v": t.xy,
        "txx_o": to.xx, "tyy_o": to.yy, "txy_c_o": to.xy_c,
        "txy_v_o": to.xy, "EII_pl": st.EII_pl,
        "eta": st.viscosity.eta, "eta_v": st.viscosity.eta_v,
    }
    blocks = {k: B(k.removesuffix("_o"), v) for k, v in host.items()}
    nl, p = dec.ni_local, (dec.px, dec.py)
    blocks["pr_c"] = block_staggered_nd(np.asarray(pr_c), nl + (2,), p + (1,),
                                        (0, 0, 0))
    blocks["pr_v"] = block_staggered_nd(np.asarray(pr_v), nl + (2,), p + (1,),
                                        (1, 1, 0))
    blocks = {k: jnp.asarray(v) for k, v in blocks.items()}
    blocks["inv_dx"] = 1.0 / geometry.di[0]
    blocks["inv_dy"] = 1.0 / geometry.di[1]
    with mesh:
        res = _sharded_run(phase, solve_vep_sharded, mesh, dec, blocks,
                           (pt, bc, mat, dt), iters, compile_clock)

    def U(key, A):
        return unblock_staggered(np.asarray(A), dec, extras.get(key, (0, 0)))

    _compare(phase, {
        "Vx": (U("Vx", res.Vx), np.asarray(ref.V.Vx)),
        "Vy": (U("Vy", res.Vy), np.asarray(ref.V.Vy)),
        "P": (U("P", res.P), np.asarray(ref.P)),
        "txx": (U("txx", res.txx), np.asarray(ref.tau.xx)),
        "tyy": (U("tyy", res.tyy), np.asarray(ref.tau.yy)),
        "txy": (U("txy_v", res.txy_v), np.asarray(ref.tau.xy)),
    })


def four_cards_3d(n_local=128, iters=200, mesh_shape=(1, 2, 2),
                  compile_clock=None):
    """Sharded 3D VEP (parallel/stokes3d_vep.solve_vep_sharded_3d) on a
    1×2×2 mesh, ``n_local``³ cells per card, against serial
    ``solve_vep_3d`` of the same global problem on one card."""
    from justrelax_tpu.models import shearband3d
    from justrelax_tpu.parallel.decomp import (
        Decomp3D,
        block_staggered_nd,
        unblock_staggered_nd,
    )
    from justrelax_tpu.parallel.stokes3d_vep import solve_vep_sharded_3d
    from justrelax_tpu.solvers.stokes3d_vep import solve_vep_3d

    phase = "four_cards_3d"
    ni = tuple(n_local * m for m in mesh_shape)
    args = shearband3d.setup(ni)
    st, pt, geometry, bc, mat, pr_c, pr_e, dt = args
    ref = _serial_run(phase, solve_vep_3d, args, iters, compile_clock)

    devs = np.array(jax.devices()[:4]).reshape(mesh_shape)
    mesh = jax.sharding.Mesh(devs, ("x", "y", "z"))
    dec = Decomp3D.make(ni, mesh_shape)
    nl, p = dec.ni_local, dec.mesh_shape
    extras = {"Vx": (1, 2, 2), "Vy": (2, 1, 2), "Vz": (2, 2, 1),
              "tyz": (0, 1, 1), "txz": (1, 0, 1), "txy": (1, 1, 0)}

    def B(key, A):
        return block_staggered_nd(np.asarray(A), nl, p,
                                  extras.get(key, (0, 0, 0)))

    t, to = st.tau, st.tau_o
    host = {
        "Vx": st.V.Vx, "Vy": st.V.Vy, "Vz": st.V.Vz, "P": st.P, "Q": st.Q,
        "txx": t.xx, "tyy": t.yy, "tzz": t.zz,
        "tyz_c": t.yz_c, "txz_c": t.xz_c, "txy_c": t.xy_c,
        "tyz": t.yz, "txz": t.xz, "txy": t.xy,
        "txx_o": to.xx, "tyy_o": to.yy, "tzz_o": to.zz,
        "tyz_c_o": to.yz_c, "txz_c_o": to.xz_c, "txy_c_o": to.xy_c,
        "tyz_o": to.yz, "txz_o": to.xz, "txy_o": to.xy,
        "EII_pl": st.EII_pl, "eta": st.viscosity.eta,
    }
    blocks = {k: B(k.removesuffix("_o"), v) for k, v in host.items()}
    for k, A, ex in (("pr_c", pr_c, (0, 0, 0)), ("pr_yz", pr_e[0], (0, 1, 1)),
                     ("pr_xz", pr_e[1], (1, 0, 1)),
                     ("pr_xy", pr_e[2], (1, 1, 0))):
        blocks[k] = block_staggered_nd(np.asarray(A), nl + (A.shape[-1],),
                                       p + (1,), ex + (0,))
    blocks = {k: jnp.asarray(v) for k, v in blocks.items()}
    for ax, d in zip("xyz", geometry.di):
        blocks[f"inv_d{ax}"] = 1.0 / d
    with mesh:
        res = _sharded_run(phase, solve_vep_sharded_3d, mesh, dec, blocks,
                           (pt, bc, mat, dt), iters, compile_clock)

    def U(key, A):
        return unblock_staggered_nd(np.asarray(A), nl, p,
                                    extras.get(key, (0, 0, 0)))

    pairs = {k: (U(k, getattr(res, k)), np.asarray(v)) for k, v in (
        ("Vx", ref.V.Vx), ("Vy", ref.V.Vy), ("Vz", ref.V.Vz), ("P", ref.P),
        ("txx", ref.tau.xx), ("tzz", ref.tau.zz), ("tyz", ref.tau.yz),
        ("txz", ref.tau.xz), ("txy", ref.tau.xy))}
    _compare(phase, pairs)


# --------------------------------------------------------------------------
# running the phases
# --------------------------------------------------------------------------
def run_phases(phases):
    """Run ``(name, thunk)`` pairs in order. The first that raises stops the
    run: its traceback goes to stderr and the return value is 1."""
    for name, thunk in phases:
        t0 = time.perf_counter()
        try:
            thunk()
        except Exception as exc:  # noqa: BLE001 - the run's one boundary
            traceback.print_exc(file=sys.stderr)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                  f"{type(exc).__name__}: {exc}", flush=True)
            return 1
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded-vs-serial check on four "
                         "cards")
    opts = ap.parse_args(argv)

    jax.config.update("jax_enable_x64", True)
    device.enable_compile_cache()
    from justrelax_tpu.utils.timing import CompileClock

    smi = []
    host = {}
    with CompileClock() as clock:
        def dev():
            smi.append(phase_device(opts.cards))

        def start_host():
            host["2d"] = start_host_2d()
            host["3d"] = start_host_3d()

        if opts.cards == 4:
            phases = [
                ("device", dev),
                ("four_cards_2d", lambda: four_cards_2d(compile_clock=clock)),
                ("four_cards_3d", lambda: four_cards_3d(compile_clock=clock)),
            ]
        else:
            phases = [
                ("device", dev),
                ("host_reference", start_host),
                ("goldens", phase_goldens),
                ("shearband2d", lambda: phase_shearband2d(
                    host["2d"], compile_clock=clock)),
                ("shearband3d", lambda: phase_shearband3d(
                    host["3d"], compile_clock=clock)),
                ("coupled", lambda: phase_coupled(clock)),
                ("xla_passes", phase_xla_passes),
            ]
        rc = run_phases(phases)
    if rc:
        return rc
    for line in smi[0].splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    print(json.dumps({"ok": True, "device": device.device_record()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
