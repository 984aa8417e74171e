"""Test configuration: CPU backend with 8 virtual devices, 64-bit precision.

Golden-value tests mirror the reference's Float64 CPU test suite
(/root/reference/test/runtests.jl); distributed tests use the 8-device virtual
CPU mesh. The GPU path is exercised by ``python chip_smoke.py`` on the card;
tests marked ``gpu`` need a card and skip here.
"""

import os
import subprocess
import sys

import pytest

# force the CPU backend, whatever accelerator the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The ``nvidia-smi`` lines of the machine's cards; skips the test where
    there is none. Decided when the test runs, never while a module is
    imported, so every test worker collects the same tests. This process
    stays on the CPU: a test that needs the card runs its work in a child
    process, the one JAX process on the card."""
    from justrelax_tpu.utils.device import nvidia_smi

    try:
        cards = nvidia_smi()
    except (OSError, subprocess.SubprocessError):
        cards = ""
    if not cards:
        pytest.skip("needs a GPU card (run on the card: pytest -m gpu)")
    return cards


def card_env():
    """The environment for a child process that uses the card."""
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
