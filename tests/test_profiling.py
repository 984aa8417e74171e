"""Observability layer: metrics, NaN guards, env report (SURVEY §5 —
the reference's @elapsed/isnan/versioninfo equivalents)."""

import jax.numpy as jnp
import numpy as np
import pytest

from justrelax_tpu.utils.profiling import (
    assert_finite,
    effective_bandwidth,
    report_env,
    solve_report,
    timed,
)


class _FakeInfo:
    def __init__(self, iters, err):
        self.iters = iters
        self.err = jnp.asarray(err)


def test_effective_bandwidth():
    # 23 fields × 1024² × 8 B in 1 ms → 172.9 GB/s
    t = effective_bandwidth((1024, 1024), 1.0e-3)
    np.testing.assert_allclose(t, 23 * 1024 * 1024 * 8 / 1e-3 / 1e9)


def test_solve_report():
    info = _FakeInfo(1000, 1.0e-9)
    r = solve_report(info, (256, 256), wall_s=0.5, hbm_peak_gbs=1000.0)
    assert r["iters"] == 1000
    np.testing.assert_allclose(r["gups"], 256 * 256 * 1000 / 0.5 / 1e9)
    np.testing.assert_allclose(
        r["T_eff_GBs"], 23 * 256 * 256 * 8 / (0.5 / 1000) / 1e9
    )
    assert 0 < r["frac_speed_of_light"] < 1


def test_assert_finite():
    assert_finite(_FakeInfo(1, 1.0e-6), jnp.ones((3, 3)))  # clean
    with pytest.raises(FloatingPointError, match="NaN"):
        assert_finite(_FakeInfo(1, jnp.nan))
    with pytest.raises(FloatingPointError, match="NaN"):
        assert_finite(jnp.asarray([1.0, jnp.inf]))
    with pytest.raises(FloatingPointError, match="divergence"):
        assert_finite(_FakeInfo(1, 1.0e12))


def test_timed_and_report_env(capsys):
    out = {}
    with timed(out):
        _ = jnp.ones((8, 8)).sum().block_until_ready()
    assert out["wall_s"] > 0
    env = report_env()
    assert env["backend"] == "cpu" and int(env["n_devices"]) >= 1
    assert "jax" in capsys.readouterr().out
