"""The 3D particle stress rotation τ' = R τ Rᵀ in float32 against numpy.

The product is written as elementwise products summed over the 3×3 axes
(ops/stress_rotation.py), so no matrix unit and no reduced-precision mode
(TF32) can enter. Held to 1e-5 relative in f32: about 20 float32 rounding
errors per entry (2·3 products and sums per matrix product, two products)."""

import numpy as np
import pytest
import jax.numpy as jnp

from justrelax_tpu.ops.stress_rotation import rotate_stress_particles_3d


def _rodrigues(w, dt):
    th = np.linalg.norm(w) * dt
    if th == 0.0:
        return np.eye(3)
    n = w / np.linalg.norm(w)
    K = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]], [-n[1], n[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_f32_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    npart = 64
    t = rng.normal(size=(6, npart))           # xx yy zz yz xz xy
    om = rng.normal(size=(3, npart)) * 0.5    # omega_yz, omega_xz, omega_xy
    dt = 0.3
    got = rotate_stress_particles_3d(
        *(jnp.asarray(a, jnp.float32) for a in t),
        *(jnp.asarray(a, jnp.float32) for a in om), dt)
    assert all(g.dtype == jnp.float32 for g in got)
    for p in range(npart):
        xx, yy, zz, yz, xz, xy = t[:, p]
        tau = np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]])
        w = np.array([om[0, p], -om[1, p], om[2, p]])
        R = _rodrigues(w, dt)
        want = R @ tau @ R.T
        ref = [want[0, 0], want[1, 1], want[2, 2],
               want[1, 2], want[0, 2], want[0, 1]]
        scale = np.abs(tau).max()
        np.testing.assert_allclose(
            [float(g[p]) for g in got], ref, rtol=0, atol=1e-5 * scale)
