"""Tracing, performance metrics, and run observability.

The reference's observability layer is minimal (SURVEY §5): ``@elapsed``
wall-clock accumulation in the solvers (Stokes2D.jl:66), residual histories,
NaN aborts (``isnan(err) && error("NaN(s)")``, Stokes2D.jl:144), and a
``versioninfo()`` runtime report (JustRelax.jl:87-165). This module adds
``jax.profiler`` trace capture, the per-kernel effective
memory bandwidth (T_eff) figure of merit the APT method is judged by
(Räss et al. 2022), and equivalent NaN/divergence guards that work with
device-resident solves.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = Any

__all__ = [
    "trace",
    "timed",
    "effective_bandwidth",
    "solve_report",
    "assert_finite",
    "report_env",
]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``jax.profiler`` trace for the enclosed block (view with
    TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(out: Dict[str, float], key: str = "wall_s"):
    """Wall-clock a block into ``out[key]``, forcing device completion at
    exit (the reference's ``@elapsed`` around the solver loop)."""
    t0 = time.perf_counter()
    yield
    out[key] = time.perf_counter() - t0


def effective_bandwidth(ni, t_iter: float, n_fields: int = 23, dtype_bytes: int = 8):
    """T_eff [GB/s]: the APT figure of merit — necessary memory traffic of
    one fused PT iteration over its wall time (Räss et al. 2022 convention:
    ``n_fields`` = reads+writes of unknowns + reads of fields; 23 for the 2D
    VE Stokes iteration)."""
    n = 1
    for d in ni:
        n *= int(d)
    return n_fields * n * dtype_bytes / max(t_iter, 1e-300) / 1.0e9


def solve_report(
    info,
    ni,
    wall_s: float,
    n_fields: int = 23,
    dtype_bytes: int = 8,
    hbm_peak_gbs: Optional[float] = None,
) -> Dict[str, float]:
    """Summarize a solve: iterations, final residual, grid-updates/s, T_eff
    (and fraction of the memory-bandwidth peak if ``hbm_peak_gbs`` is
    given)."""
    iters = int(info.iters)
    n = 1
    for d in ni:
        n *= int(d)
    t_iter = wall_s / max(iters, 1)
    out = {
        "iters": float(iters),
        "err": float(info.err),
        "wall_s": float(wall_s),
        "gups": n * max(iters, 1) / max(wall_s, 1e-300) / 1.0e9,
        "T_eff_GBs": effective_bandwidth(ni, t_iter, n_fields, dtype_bytes),
    }
    if hbm_peak_gbs:
        out["frac_speed_of_light"] = out["T_eff_GBs"] / hbm_peak_gbs
    return out


def assert_finite(*arrays_or_info, context: str = "solve"):
    """Host-side NaN/Inf guard (the reference's ``isnan(err) &&
    error("NaN(s)")`` / DYREL ``err > 1e10 && error("Kaboom!")``). Accepts
    arrays and/or solver info objects (anything with ``.err``)."""
    for a in arrays_or_info:
        x = getattr(a, "err", a)
        v = np.asarray(jax.device_get(x))
        if not np.isfinite(v).all():
            raise FloatingPointError(
                f"NaN(s)/Inf in {context}: {type(a).__name__}"
            )
        if v.size == 1 and abs(float(v)) > 1.0e10:
            raise FloatingPointError(
                f"divergence in {context}: |err| = {float(v):.3e} > 1e10"
            )


def report_env() -> Dict[str, str]:
    """Runtime report (the reference's ``versioninfo()``,
    JustRelax.jl:87-165): jax version, backend, devices, precision."""
    devs = jax.devices()
    info = {
        "jax": jax.__version__,
        "backend": devs[0].platform if devs else "none",
        "devices": ", ".join(str(d) for d in devs),
        "n_devices": str(len(devs)),
        "x64": str(jax.config.jax_enable_x64),
    }
    for k, v in info.items():
        print(f"{k:>10}: {v}")
    return info
