"""The device a measurement runs on: GPU check, peak table, card readout,
persistent compile cache.

Measurement entry points (``bench.py``, ``chip_smoke.py``) call
:func:`require_gpu` and :func:`enable_compile_cache` before their first
compile. Nothing here falls back to the CPU: a run that finds no GPU stops.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, NamedTuple, Tuple

import jax

__all__ = [
    "Peaks",
    "PEAKS",
    "peaks",
    "require_gpu",
    "device_record",
    "parse_nvidia_smi",
    "nvidia_smi",
    "enable_compile_cache",
    "REPO_ROOT",
]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Peaks(NamedTuple):
    """Published peak rates of one card (dense, without sparsity)."""

    hbm_GBs: float      # device-memory bandwidth
    fp32_TFs: float     # FP32 outside the tensor cores
    fp64_TFs: float     # FP64 outside the tensor cores
    source: str


# Keyed by ``jax.devices()[0].device_kind``. Source: NVIDIA H100 Tensor Core
# GPU data sheet (SXM5 and PCIe columns); rates assume the card's full power
# limit (700 W SXM, 350 W PCIe).
_H100_SHEET = "NVIDIA H100 Tensor Core GPU data sheet"
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3350.0, 67.0, 34.0, _H100_SHEET + ", SXM"),
    "NVIDIA H100 PCIe": Peaks(2000.0, 51.0, 26.0, _H100_SHEET + ", PCIe"),
}


def peaks(device_kind: str) -> Peaks:
    """Peak rates of ``device_kind``. A kind not in :data:`PEAKS` raises:
    a roofline share against a guessed peak is not a measurement."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak table entry for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


def require_gpu():
    """Return the default device if it is a GPU; otherwise raise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, but JAX's default device is {dev.platform!r}"
            f" ({dev.device_kind}); there is no CPU fallback")
    return dev


def device_record() -> dict:
    """The default device as JAX reports it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def parse_nvidia_smi(text: str) -> List[Tuple[str, str]]:
    """``name, power.limit`` pairs from the output of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def nvidia_smi() -> str:
    """The raw ``name, power.limit`` lines of every card. Runs nvidia-smi
    as a child process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
    else is set here. Otherwise the cache is the fixed ``<repo>/.jax_cache``
    (listed in .gitignore): a fixed path, so a later run finds it again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
