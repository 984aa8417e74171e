"""Melt-fraction parameterizations and melt-dependent properties.

JAX-native equivalent of the reference melting layer
(/root/reference/src/rheology/Melting.jl:1-26, which delegates per cell to
GeoParams ``compute_meltfraction``) and of the melt/bubble/gas-dependent
thermal-expansivity shims (/root/reference/src/rheology/GeoParams.jl:17-59).
Here the parameterizations are explicit, vectorized closures over the whole
temperature field — one fused XLA kernel instead of a per-cell dispatch.

Parameterizations (GeoParams names kept for familiarity):

- :class:`MeltingCaricchi` — sigmoid ϕ = 1/(1+exp((a − (T−c))/b)) with the
  Caricchi et al. defaults a=800 °C, b=23 K, c=273.15 K (used by the
  reference thermal-stress and volcano models, e.g.
  miniapps/benchmarks/thermal_stress/Thermal_Stress_Magma_Chamber_nondim.jl:164).
- :class:`MeltingQuadratic` — ϕ = 1 − ((T_l − T)/(T_l − T_s))², clamped.
- :class:`MeltingPolynomial` — generic clamped polynomial ϕ = Σ cᵢ·x^i with
  x = T/T_scale, valid on [T_s, T_l] (covers the 3rd/4th/5th-order GeoParams
  families once coefficients are supplied; the exact built-in coefficient
  conventions of e.g. ``MeltingParam_Smooth3rdOrder`` are GeoParams
  internals to be pinned from source next round).

All take/return plain arrays (temperature in Kelvin) and provide ``dphi_dT``
for latent-heat couplings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import jax.numpy as jnp

Array = Any

__all__ = [
    "MeltingCaricchi",
    "MeltingQuadratic",
    "MeltingPolynomial",
    "NoMelting",
    "compute_melt_fraction",
    "melt_dependent_alpha",
    "bubble_flow_alpha",
    "gas_pyroclast_alpha",
    "melt_dependent_density",
]


@dataclass(frozen=True)
class NoMelting:
    """ϕ ≡ 0 (phases with no Melting entry in the reference rheology)."""

    def phi(self, T, P=None):
        return jnp.zeros_like(T)

    def dphi_dT(self, T, P=None):
        return jnp.zeros_like(T)


@dataclass(frozen=True)
class MeltingCaricchi:
    """Caricchi et al. (2007) sigmoid melting curve (GeoParams
    ``MeltingParam_Caricchi``): θ = (a − (T − c))/b, ϕ = 1/(1+exp(θ))."""

    a: float = 800.0  # °C
    b: float = 23.0  # K
    c: float = 273.15  # K→°C shift

    def phi(self, T, P=None):
        theta = (self.a - (T - self.c)) / self.b
        return 1.0 / (1.0 + jnp.exp(theta))

    def dphi_dT(self, T, P=None):
        phi = self.phi(T)
        return phi * (1.0 - phi) / self.b


@dataclass(frozen=True)
class MeltingQuadratic:
    """Quadratic melting curve between solidus ``Ts`` and liquidus ``Tl``
    (GeoParams ``MeltingParam_Quadratic``): ϕ = 1 − ((Tl−T)/(Tl−Ts))²."""

    Ts: float = 963.15
    Tl: float = 1273.15

    def phi(self, T, P=None):
        x = (self.Tl - T) / (self.Tl - self.Ts)
        return jnp.where(T >= self.Tl, 1.0, jnp.clip(1.0 - x * x, 0.0, 1.0))

    def dphi_dT(self, T, P=None):
        dTr = self.Tl - self.Ts
        x = (self.Tl - T) / dTr
        inside = (T > self.Ts) & (T < self.Tl)
        return jnp.where(inside, 2.0 * x / dTr, 0.0)


@dataclass(frozen=True)
class MeltingPolynomial:
    """Clamped polynomial melting curve ϕ(x) = Σ coeffs[i]·x^i with
    x = T/T_scale, forced to 0 below ``Ts`` and 1 above ``Tl``."""

    coeffs: Tuple[float, ...]
    Ts: float
    Tl: float
    T_scale: float = 1.0e3

    def phi(self, T, P=None):
        x = T / self.T_scale
        acc = jnp.zeros_like(T)
        for c in reversed(self.coeffs):
            acc = acc * x + c
        acc = jnp.clip(acc, 0.0, 1.0)
        return jnp.where(T <= self.Ts, 0.0, jnp.where(T >= self.Tl, 1.0, acc))

    def dphi_dT(self, T, P=None):
        x = T / self.T_scale
        acc = jnp.zeros_like(T)
        n = len(self.coeffs)
        for i in range(n - 1, 0, -1):
            acc = acc * x + i * self.coeffs[i]
        inside = (T > self.Ts) & (T < self.Tl)
        return jnp.where(inside, acc / self.T_scale, 0.0)


def compute_melt_fraction(
    melting,
    T: Array,
    P: Optional[Array] = None,
    phase_ratios: Optional[Array] = None,
) -> Array:
    """Melt fraction field ϕ(T[, P]) (reference ``compute_melt_fraction!``,
    Melting.jl:1-26).

    ``melting`` is a single parameterization or a sequence of them (one per
    phase); with a sequence, ``phase_ratios`` (..., n_phase) weights the
    per-phase curves like the reference's ``fn_ratio`` path.
    """
    if isinstance(melting, (list, tuple)):
        if phase_ratios is None:
            raise ValueError("phase_ratios required for multi-phase melting")
        phi = jnp.zeros_like(T)
        for p, m in enumerate(melting):
            phi = phi + phase_ratios[..., p] * m.phi(T, P)
        return phi
    return melting.phi(T, P)


# --- melt-dependent properties (GeoParams.jl:17-59 shims) -------------------
def melt_dependent_alpha(alpha_solid, alpha_melt, phi):
    """α = ϕ·α_melt + (1−ϕ)·α_solid (``MeltDependent_Density`` expansivity)."""
    return phi * alpha_melt + (1.0 - phi) * alpha_solid


def bubble_flow_alpha(alpha_melt, alpha_gas, P, c0, a):
    """Bubble-flow effective expansivity (``BubbleFlow_Density``): gas mass
    fraction c = a·√|P| capped at c0; α = ((c0−c)/α_gas + (1−(c0−c))/α_melt)⁻¹."""
    c = jnp.where(P < (c0 / a) ** 2, a * jnp.sqrt(jnp.abs(P)), c0)
    w = c0 - c
    return 1.0 / (w / alpha_gas + (1.0 - w) / alpha_melt)


def gas_pyroclast_alpha(alpha_melt, alpha_gas, delta):
    """Gas-pyroclast mixture expansivity (``GasPyroclast_Density``)."""
    return delta * alpha_gas + (1.0 - delta) * alpha_melt


def melt_dependent_density(rho_solid, rho_melt, phi):
    """ρ = ϕ·ρ_melt + (1−ϕ)·ρ_solid (``MeltDependent_Density``)."""
    return phi * rho_melt + (1.0 - phi) * rho_solid
