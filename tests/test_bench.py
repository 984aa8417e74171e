"""bench.py refuses a device that is not a GPU; the per-family row it and
chip_smoke.py print (compile, slope timing, stream share) holds together
at a tiny size."""

import pytest

import bench
from justrelax_tpu.utils import device


def test_bench_refuses_cpu(monkeypatch):
    monkeypatch.setattr(device, "enable_compile_cache", lambda: "unused")
    with pytest.raises(RuntimeError, match="GPU is required"):
        bench.main()


def test_measure_family_row_at_tiny_size():
    from justrelax_tpu.utils.bench_kernels import measure_family

    row = measure_family("ve2d", copy_Bs=1e11, target_s=0.005, repeats=2,
                         nx=16, ny=16)
    assert row["t_iter_us"] > 0 and len(row["t_iter_us_repeats"]) == 2
    t = row["t_iter_us"] * 1e-6
    assert row["T_eff_GBs"] == pytest.approx(
        23 * 16 * 16 * 4 / t / 1e9)  # the family's necessary bytes, f32
    assert row["share_of_copy"] == pytest.approx(
        row["stream_GBs"] * 1e9 / 1e11)
