"""Device timing: wall time ending in ``block_until_ready``, per-iteration
time from the slope over two trip counts, and a copy rate measured on the
same device.

A bench family's ``step(n, carry, consts)`` runs ``n`` PT iterations with a
traced trip count, so one compile serves every trip count. The slope
``(t(n0 + dn) - t(n0)) / dn`` removes the fixed cost of a call (dispatch,
argument transfer, the loop's entry and exit).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["wall", "SlopeTiming", "slope_t_iter", "copy_rate",
           "CompileClock"]

# JAX reports each stage of turning a traced function into an executable.
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class CompileClock:
    """Seconds this process spent tracing, lowering and compiling since the
    clock was started, from JAX's own monitoring events. The difference of
    two readings around a call separates its compile time from its run
    time, however deep in the call the compile happens.

    Use as a context manager, which unregisters the listener on exit."""

    def __init__(self):
        self.seconds = 0.0

    def _listen(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.seconds += duration

    def __enter__(self):
        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        jax.monitoring.unregister_event_duration_listener(self._listen)
        return False


def wall(fn: Callable, *args):
    """``(seconds, result)`` of ``fn(*args)``, timed until the result is on
    the device (``block_until_ready``)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


class SlopeTiming(NamedTuple):
    t_iter: float       # median of the per-repeat slopes, seconds
    slopes: tuple       # every repeat's slope, seconds per iteration
    dn: int             # iterations between the two trip counts


def slope_t_iter(step: Callable, carry, consts, target_s: float = 0.3,
                 repeats: int = 3, n0: int = 10) -> SlopeTiming:
    """Seconds per iteration of a compiled ``step(n, carry, consts)``.

    ``dn`` is sized from a first estimate so that the timed difference is
    about ``target_s``; each repeat times ``n0`` and ``n0 + dn`` iterations
    from the same input carry."""

    def t(n):
        return wall(step, jnp.asarray(n, jnp.int32), carry, consts)[0]

    t(n0)  # warm-up: first execution, allocations
    est = max((t(n0 + 100) - t(n0)) / 100.0, 1.0e-7)
    dn = int(min(max(target_s / est, 50), 1_000_000))
    slopes = []
    for _ in range(repeats):
        a = t(n0)
        b = t(n0 + dn)
        slopes.append(max(b - a, 0.0) / dn)
    ordered = sorted(slopes)
    return SlopeTiming(ordered[len(ordered) // 2], tuple(slopes), dn)


def copy_rate(nbytes: int = 1 << 30, repeats: int = 3) -> float:
    """Bytes per second of a large elementwise pass (``y = y + 1`` over an
    ``nbytes`` float32 array: one read and one write per element) on the
    default device. A kernel's share of this rate says how close it comes to
    what the device's memory really delivers."""
    x = jnp.zeros((nbytes // 4,), jnp.float32)

    @jax.jit
    def step(n, y, _):
        return lax.fori_loop(0, n, lambda i, v: v + 1.0, y)

    timing = slope_t_iter(step, x, None, repeats=repeats)
    return 2.0 * x.size * 4 / timing.t_iter
