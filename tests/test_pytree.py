"""The in-repo pytree dataclass (justrelax_tpu/core/pytree.py) that every
state container is built on: leaves, static fields, ``replace``, ``jit``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.core.pytree import dataclass, field


@dataclass
class _Box:
    a: jax.Array
    b: jax.Array
    scale: float = field(static=True, default=1.0)


def test_flatten_keeps_static_fields_out_of_the_leaves():
    box = _Box(jnp.ones(3), jnp.zeros(2), scale=2.0)
    leaves, treedef = jax.tree.flatten(box)
    assert len(leaves) == 2
    back = jax.tree.unflatten(treedef, leaves)
    assert back.scale == 2.0
    np.testing.assert_array_equal(back.a, box.a)


def test_replace_returns_an_updated_copy():
    box = _Box(jnp.ones(3), jnp.zeros(2))
    new = box.replace(b=jnp.full(2, 5.0), scale=3.0)
    assert new.scale == 3.0 and box.scale == 1.0
    np.testing.assert_array_equal(new.b, [5.0, 5.0])
    np.testing.assert_array_equal(box.b, [0.0, 0.0])


def test_instances_are_frozen():
    box = _Box(jnp.ones(3), jnp.zeros(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.a = jnp.zeros(3)


def test_static_field_is_part_of_the_jit_cache_key():
    traces = []

    @jax.jit
    def f(box):
        traces.append(box.scale)  # runs only while tracing
        return box.a * box.scale + box.b.sum()

    box = _Box(jnp.ones(3), jnp.ones(2), scale=2.0)
    np.testing.assert_allclose(f(box), [4.0, 4.0, 4.0])
    f(box.replace(a=box.a * 7.0))              # same structure: no retrace
    f(box.replace(scale=5.0))                  # new static value: retrace
    assert traces == [2.0, 5.0]


@pytest.mark.parametrize("cls_name", ["StokesState", "ThermalState"])
def test_state_containers_are_pytrees(cls_name):
    import justrelax_tpu as jr

    st = getattr(jr, cls_name).make((4, 5))
    doubled = jax.tree.map(lambda x: 2 * x, st)
    assert type(doubled) is type(st)
    assert len(jax.tree.leaves(st)) > 3
