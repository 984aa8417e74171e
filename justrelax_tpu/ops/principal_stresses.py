"""Principal stresses at cell centers (reference src/stokes/PrincipalStresses.jl).

2D: closed-form 2×2 symmetric eigendecomposition (σ1/σ2 scaled eigenvector
pairs, PrincipalStresses.jl:16-40). 3D: batched symmetric eigensolve of the
3×3 deviatoric stress tensors (the reference uses a Hessenberg-QR iteration;
XLA's ``eigh`` is the JAX-native equivalent).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

Array = Any

__all__ = ["principal_stresses_2d", "principal_stresses_3d"]


class PrincipalStress2D(NamedTuple):
    sigma1: Array  # (2, nx, ny) eigenvalue-scaled eigenvector
    sigma2: Array


class PrincipalStress3D(NamedTuple):
    sigma1: Array  # (3, nx, ny, nz)
    sigma2: Array
    sigma3: Array


def principal_stresses_2d(txx, tyy, txy_c) -> PrincipalStress2D:
    a = 0.5 * (txx + tyy)
    b = jnp.sqrt((txx - tyy) ** 2 / 2.0 + txy_c**2)
    s1 = a + b
    s2 = a - b
    theta = 0.5 * jnp.arctan2(2.0 * txy_c, txx - tyy)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sigma1 = jnp.stack([s1 * ct, s1 * st])
    sigma2 = jnp.stack([-s2 * st, s2 * ct])
    return PrincipalStress2D(sigma1=sigma1, sigma2=sigma2)


def principal_stresses_3d(txx, tyy, tzz, tyz_c, txz_c, txy_c) -> PrincipalStress3D:
    T = jnp.stack(
        [
            jnp.stack([txx, txy_c, txz_c], axis=-1),
            jnp.stack([txy_c, tyy, tyz_c], axis=-1),
            jnp.stack([txz_c, tyz_c, tzz], axis=-1),
        ],
        axis=-2,
    )  # (..., 3, 3)
    w, v = jnp.linalg.eigh(T)  # ascending eigenvalues
    # order descending like the reference (σ1 ≥ σ2 ≥ σ3)
    sig = []
    for k in (2, 1, 0):
        vec = v[..., :, k] * w[..., k][..., None]
        sig.append(jnp.moveaxis(vec, -1, 0))
    return PrincipalStress3D(sigma1=sig[0], sigma2=sig[1], sigma3=sig[2])
