"""Material parameter models (GeoParams-equivalent), phase-stacked for JAX.

The reference delegates material properties (density EOS, heat capacity,
conductivity, elastic moduli, creep laws, plasticity) to GeoParams.jl with
compile-time dispatch per phase (see SURVEY.md §2.4). The JAX-native design
replaces dispatch with *fixed-arity vectorization*: a :class:`MaterialStack`
holds every parameter as a ``(nphase,)`` array, properties are evaluated for
all phases at once, and multi-phase cells combine them with phase-ratio
weighted sums — the vectorized analogue of the reference's ``fn_ratio``
(/root/reference/src/phases/phases.jl:1-30).

Supported parameterizations (unused parameters take neutral defaults):
- density:       ρ = ρ0 · (1 − α (T − T0) + β (P − P0))     [PT_Density]
- heat capacity: Cp constant
- conductivity:  k constant
- radioactivity: H_r constant (W/m³)
- elasticity:    shear modulus G, bulk modulus K (∞ → incompressible/rigid)
- viscous creep: linear viscosity η0, or power-law (dislocation) creep with
  prefactor A, stress exponent n, activation energy E (see viscosity.py)
- plasticity:    Drucker-Prager C, friction φ, dilation ψ (see plasticity.py)
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from justrelax_tpu.core.pytree import dataclass

Array = Any

__all__ = [
    "Material",
    "MaterialStack",
    "phase_average",
    "compute_density",
    "compute_rhoCp",
    "compute_conductivity",
    "compute_diffusivity",
    "compute_radioactive_heating",
    "get_shear_modulus",
    "get_bulk_modulus",
    "CREEP_PRESETS",
    "creep_preset",
]

_INF = float("inf")


@dataclass
class Material:
    """Single-phase material parameters (all scalars, traced leaves)."""

    # density EOS
    rho0: Array = 0.0
    alpha: Array = 0.0  # thermal expansivity
    beta: Array = 0.0  # compressibility
    T0: Array = 0.0
    P0: Array = 0.0
    # thermal
    Cp: Array = 0.0
    k: Array = 0.0
    H_r: Array = 0.0  # radiogenic heating [W/m³]
    # elasticity
    G: Array = _INF
    Kb: Array = _INF
    # linear viscous creep
    eta0: Array = 1.0
    # power-law (dislocation) creep:
    #   η_eff = ½ A^(-1/n) εII^(1/n − 1) exp((E + P·V)/(nRT))
    disl_A: Array = 0.0  # 0 disables
    disl_n: Array = 1.0
    disl_E: Array = 0.0
    disl_V: Array = 0.0  # activation volume [m³/mol]
    # diffusion creep (linear, grain-size sensitive):
    #   η_eff = ½ A⁻¹ d^m exp((E + P·V)/(RT))
    diff_A: Array = 0.0  # 0 disables
    diff_E: Array = 0.0
    diff_V: Array = 0.0
    diff_m: Array = 0.0  # grain-size exponent
    grain_size: Array = 1.0e-3  # d [m]
    # Peierls (low-temperature plasticity) creep (GeoParams PeierlsCreep):
    #   ε̇ = A τⁿ exp(−E/(RT)·(1 − (τ/τP)^o)^q)
    # τ(ε̇) has no closed form — inverted with a fixed Newton loop in
    # rheology/viscosity.py (mode "eps"); mode "tau" is direct.
    peierls_A: Array = 0.0  # 0 disables [Pa^-n / s]
    peierls_n: Array = 2.0
    peierls_E: Array = 0.0  # [J/mol]
    peierls_q: Array = 1.0
    peierls_o: Array = 0.5
    peierls_tauP: Array = _INF  # Peierls stress τP [Pa]
    # dislocation-accommodated grain-boundary sliding (GeoParams
    # GrainBoundarySliding): ε̇ = A τⁿ d^−m exp(−(E + P·V)/(RT)) —
    # power-law with a grain-size factor, analytically invertible.
    gbs_A: Array = 0.0  # 0 disables [Pa^-n m^m / s]
    gbs_n: Array = 1.0
    gbs_m: Array = 0.0
    gbs_E: Array = 0.0
    gbs_V: Array = 0.0
    # Drucker-Prager plasticity (is_plastic=1 enables yielding for the phase)
    is_plastic: Array = 0.0
    C: Array = 0.0  # cohesion
    friction_angle: Array = 0.0  # φ [degrees]
    dilation_angle: Array = 0.0  # ψ [degrees]
    eta_reg: Array = 0.0  # Kelvin viscoplastic regularization η_vp
    # tension cap: elliptic closure of the DP cone at P = pT < 0 (GeoParams
    # DruckerPragerCap pT; 0 disables — see plasticity._tension_cap_yield)
    tension_pT: Array = 0.0
    # ∂Q/∂τ shear-slot convention (un-retrievable GeoParams v0.7.17 internal
    # — see PARITY.md): 0 = mathematically consistent tensor gradient
    # (shear slot τ/(2τII)); 1 = the bracketing candidate (extra halving of
    # the shear slot → τ/(4τII)). The two conventions straddle the published
    # ShearBand2D golden values from opposite sides.
    dqdtau_alt: Array = 0.0
    # linear softening of C / φ to (soft_*_min) over EII ∈ [lo, hi]
    soft_C_active: Array = 0.0
    soft_C_min: Array = 0.0
    soft_phi_active: Array = 0.0
    soft_phi_min: Array = 0.0
    soft_strain_lo: Array = 0.0
    soft_strain_hi: Array = 1.0
    # nonlinear cohesion softening (GeoParams ``NonLinearSoftening``; used by
    # the reference softening shearband, test_shearband2D_softening.jl:99-105,
    # and the caldera/blob miniapps): the softened cohesion is derived from
    # ξ₀ alone — the functor IGNORES the phase's C — decaying from ξ₀ toward
    # ξ₀ − Δ with accumulated plastic strain. GeoParams v0.7.17's exact decay
    # constant is not retrievable here (PARITY.md); we use an exponential
    # decay over the scale ``soft_C_nl_eps_ref`` (the reference golden test
    # never accumulates enough strain for the shape to matter — yield onset
    # is controlled by ξ(0) = ξ₀ alone).
    soft_C_nl: Array = 0.0  # 0 disables
    soft_C_nl_xi0: Array = 0.0
    soft_C_nl_delta: Array = 0.0
    soft_C_nl_eps_ref: Array = 1.0e-2
    # gravity (magnitude, applied along the last axis, pointing "down")
    gravity: Array = 0.0


@dataclass
class MaterialStack:
    """``nphase`` materials stacked: every field has shape ``(nphase,)``."""

    params: Material

    @classmethod
    def make(cls, materials: Sequence[Material]) -> "MaterialStack":
        fields = {}
        names = [f.name for f in Material.__dataclass_fields__.values()]
        for name in names:
            fields[name] = jnp.stack(
                [jnp.asarray(getattr(m, name), dtype=jnp.result_type(float)) for m in materials]
            )
        return cls(params=Material(**fields))

    @property
    def nphase(self) -> int:
        return int(np.shape(self.params.rho0)[0])


def _as_stack(material) -> MaterialStack:
    if isinstance(material, MaterialStack):
        return material
    if isinstance(material, Material):
        return MaterialStack.make([material])
    if isinstance(material, (list, tuple)):
        return MaterialStack.make(list(material))
    raise TypeError(f"cannot interpret {material!r} as MaterialStack")


def phase_average(values: Array, phase_ratios: Optional[Array]) -> Array:
    """Phase-ratio weighted sum (vectorized ``fn_ratio``).

    ``values`` has shape ``(..., nphase)`` or ``(nphase,)``; ``phase_ratios``
    has shape ``(*grid, nphase)`` (or ``None`` for single-phase: returns the
    phase-0 values).
    """
    if phase_ratios is None:
        return values[..., 0]
    return jnp.sum(values * phase_ratios, axis=-1)


def _bcast(param: Array, T: Optional[Array]) -> Array:
    """Broadcast (nphase,) params against a (*grid,) field → (*grid, nphase)."""
    if T is None:
        return param
    return param.reshape((1,) * T.ndim + (-1,))


def compute_density(material, T=None, P=None, phase_ratios=None) -> Array:
    """ρ(T, P) per cell (reference: GeoParams PT_Density)."""
    m = _as_stack(material).params
    ref = T if T is not None else P
    rho0 = _bcast(m.rho0, ref)
    rho = rho0
    if T is not None:
        rho = rho * (1.0 - _bcast(m.alpha, ref) * (T[..., None] - _bcast(m.T0, ref)))
    if P is not None:
        beta = _bcast(m.beta, ref)
        rho = rho + rho0 * beta * (P[..., None] - _bcast(m.P0, ref))
    return phase_average(rho, phase_ratios)


def compute_rhoCp(material, T=None, P=None, phase_ratios=None) -> Array:
    """ρ(T,P)·Cp per cell, phase-weighted on the product (not the factors)."""
    ref = T if T is not None else P
    stack = _as_stack(material).params
    rho0 = _bcast(stack.rho0, ref)
    rho_p = rho0
    if T is not None:
        rho_p = rho_p * (1.0 - _bcast(stack.alpha, ref) * (T[..., None] - _bcast(stack.T0, ref)))
    if P is not None:
        rho_p = rho_p + rho0 * _bcast(stack.beta, ref) * (P[..., None] - _bcast(stack.P0, ref))
    rhoCp = rho_p * _bcast(stack.Cp, ref)
    return phase_average(rhoCp, phase_ratios)


def compute_conductivity(material, T=None, P=None, phase_ratios=None) -> Array:
    m = _as_stack(material).params
    k = _bcast(m.k, T if T is not None else P)
    out = phase_average(k, phase_ratios)
    if phase_ratios is None and T is not None:
        out = jnp.broadcast_to(out, T.shape)
    return out


def compute_diffusivity(material, T=None, P=None, phase_ratios=None) -> Array:
    """Thermal diffusivity κ = k/(ρ·Cp) per cell (reference
    compute_diffusivity, src/thermal_diffusion/DiffusionPT_GeoParams.jl; same
    single-material / phase-ratio signatures as the other helpers)."""
    return compute_conductivity(material, T=T, P=P, phase_ratios=phase_ratios) / \
        compute_rhoCp(material, T=T, P=P, phase_ratios=phase_ratios)


def compute_radioactive_heating(material, phase_ratios=None) -> Array:
    m = _as_stack(material).params
    return phase_average(m.H_r, phase_ratios)


def _phase_average_inf_safe(values: Array, phase_ratios: Optional[Array]) -> Array:
    """Ratio-weighted sum skipping zero-ratio phases (the reference's
    ``fn_ratio`` skips them too) — avoids ∞·0 → NaN for infinite moduli."""
    if phase_ratios is None:
        return values[..., 0]
    contrib = jnp.where(phase_ratios > 0, values * phase_ratios, 0.0)
    return jnp.sum(contrib, axis=-1)


def get_shear_modulus(material, phase_ratios=None) -> Array:
    m = _as_stack(material).params
    # NaN/0 → ∞ per reference shim (src/rheology/GeoParams.jl:1-20)
    G = jnp.where((m.G == 0) | jnp.isnan(m.G), _INF, m.G)
    return _phase_average_inf_safe(G, phase_ratios)


def get_bulk_modulus(material, phase_ratios=None) -> Array:
    m = _as_stack(material).params
    Kb = jnp.where((m.Kb == 0) | jnp.isnan(m.Kb), _INF, m.Kb)
    return _phase_average_inf_safe(Kb, phase_ratios)


# --- named creep-law presets -------------------------------------------------
# Hirth & Kohlstedt (2003), "Rheology of the upper mantle and the mantle
# wedge: a view from the experimentalists", as used by the reference's
# subduction miniapps via GeoParams (Dislocation.wet_olivine1_Hirth_2003 /
# Diffusion.wet_olivine_Hirth_2003). Published values are MPa- and
# micrometer-based; here converted to SI (Pa, m): A_Pa = A_MPa·1e-6ⁿ·(1e-6)^m.
# Wet laws fold the water-content factor C_OH^r at C_OH = 1000 ppm H/Si into
# A (this framework does not carry a separate fugacity field yet). Exact
# GeoParams database parity to be pinned from source next round.
CREEP_PRESETS = {
    "dry_olivine_disl_Hirth_2003": dict(
        disl_A=1.1e5 * 1.0e-6**3.5, disl_n=3.5, disl_E=530.0e3, disl_V=14.0e-6,
    ),
    "wet_olivine_disl_Hirth_2003": dict(
        # A = 1600 MPa^-3.5 s^-1 · C_OH^1.2 with C_OH = 1000
        disl_A=1600.0 * 1000.0**1.2 * 1.0e-6**3.5,
        disl_n=3.5, disl_E=520.0e3, disl_V=22.0e-6,
    ),
    "dry_olivine_diff_Hirth_2003": dict(
        # A = 1.5e9 MPa^-1 um^3 s^-1, m = 3
        diff_A=1.5e9 * 1.0e-6 * (1.0e-6) ** 3, diff_m=3.0,
        diff_E=375.0e3, diff_V=6.0e-6,
    ),
    "wet_olivine_diff_Hirth_2003": dict(
        # A = 2.5e7 MPa^-1 um^3 s^-1 · C_OH^1.0 with C_OH = 1000
        diff_A=2.5e7 * 1000.0 * 1.0e-6 * (1.0e-6) ** 3, diff_m=3.0,
        diff_E=375.0e3, diff_V=10.0e-6,
    ),
    # Peierls low-temperature plasticity, dry olivine, Mei et al. (2010)
    # (GeoParams PeierlsCreep "Dry Olivine | Mei et al. (2010)"):
    # A = 1.4e-7 MPa^-2 s^-1, n = 2, E = 320 kJ/mol, τP = 5.9 GPa,
    # o = 1/2, q = 1.
    "dry_olivine_peierls_Mei_2010": dict(
        peierls_A=1.4e-7 * 1.0e-6**2, peierls_n=2.0, peierls_E=320.0e3,
        peierls_q=1.0, peierls_o=0.5, peierls_tauP=5.9e9,
    ),
    # Peierls, Goetze & Evans (1979) flow-law shape (q = 2, o = 1, n = 0 →
    # stress enters only through the exponential; implemented with n = 2 and
    # rescaled A as the common regularized form, cf. Kameyama et al. 1999):
    "dry_olivine_peierls_Goetze_1979": dict(
        peierls_A=5.7e11 / (8.5e9) ** 2, peierls_n=2.0, peierls_E=536.0e3,
        peierls_q=2.0, peierls_o=1.0, peierls_tauP=8.5e9,
    ),
    # Dislocation-accommodated grain-boundary sliding, dry olivine < 1523 K,
    # Hansen et al. (2011) (GeoParams GrainBoundarySliding):
    # A = 10^4.8 MPa^-2.9 μm^0.7 s^-1, n = 2.9, m = 0.7, E = 445 kJ/mol.
    "dry_olivine_gbs_Hansen_2011": dict(
        gbs_A=10.0**4.8 * 1.0e-6**2.9 * (1.0e-6) ** 0.7,
        gbs_n=2.9, gbs_m=0.7, gbs_E=445.0e3, gbs_V=18.0e-6,
    ),
}


def creep_preset(*names: str) -> dict:
    """Merge named creep presets into Material kwargs, e.g.
    ``Material(**creep_preset("wet_olivine_disl_Hirth_2003",
    "wet_olivine_diff_Hirth_2003"), rho0=3.3e3, ...)`` composes dislocation +
    diffusion creep harmonically (see rheology/viscosity.py)."""
    out = {}
    for n in names:
        if n not in CREEP_PRESETS:
            raise KeyError(
                f"unknown creep preset {n!r}; available: {sorted(CREEP_PRESETS)}"
            )
        out.update(CREEP_PRESETS[n])
    return out
