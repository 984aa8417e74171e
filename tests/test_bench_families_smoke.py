"""Smoke test: every bench family in utils/bench_kernels.py::FAMILIES must
*instantiate* and *trace* at a tiny grid, so a family registered with stale
kwargs is caught before a device run.

`jax.eval_shape` traces the step (catching signature drift and shape
mismatches at trace time) without compiling it, so this runs on the CPU
suite.
"""

import jax
import jax.numpy as jnp
import pytest

from justrelax_tpu.utils import bench_kernels as bk

# Per-family tiny-but-valid sizes.
SMOKE_KWARGS = {
    "ve2d": dict(nx=32, ny=32),
    "vep2d": dict(n=32),
    "thermal2d": dict(nx=32, ny=32),
    "thermal3d": dict(n=16),
    "ve3d": dict(n=16),
    "ve3d_canvas": dict(n=16),
    "vep3d": dict(n=16),
    "vep3d_canvas": dict(n=16),
}


def test_every_family_registered_has_smoke_kwargs():
    assert set(SMOKE_KWARGS) == set(bk.FAMILIES)


@pytest.mark.parametrize("name", sorted(bk.FAMILIES))
def test_family_instantiates_and_traces(name):
    step, carry, consts, bytes_per_iter, n_cells = bk.FAMILIES[name](
        **SMOKE_KWARGS[name]
    )
    assert bytes_per_iter > 0 and n_cells > 0
    out = jax.eval_shape(step, jnp.asarray(2, jnp.int32), carry, consts)
    # tracing succeeded; the output must be a non-empty pytree of concrete
    # shapes (some families return a richer pytree than their timed carry,
    # so structure preservation is not asserted universally)
    leaves = jax.tree.leaves(out)
    assert leaves
    for o in leaves:
        assert hasattr(o, "shape") and hasattr(o, "dtype")
