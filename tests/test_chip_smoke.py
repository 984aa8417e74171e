"""chip_smoke.py and the device helpers it stands on, on the CPU.

The script refuses to run without a GPU, so here its phases run one by one
at tiny sizes (the card-vs-host and sharded-vs-serial checks compare the CPU
with itself, or 4 virtual CPU devices with one), and the runner around them
runs with the phases replaced.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from justrelax_tpu.utils import device
from justrelax_tpu.utils.timing import CompileClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clock():
    with CompileClock() as c:
        yield c


# --- the device check, the card readout, the peak table, the cache --------
def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        device.require_gpu()


@pytest.mark.parametrize("text, cards", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 650.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "650.00 W")]),
    ("\n  NVIDIA H100 PCIe, 350.00 W  \n\n",
     [("NVIDIA H100 PCIe", "350.00 W")]),
    ("", []),
])
def test_parse_nvidia_smi(text, cards):
    assert device.parse_nvidia_smi(text) == cards


@pytest.mark.parametrize("bad", ["no comma here", ", 700 W"])
def test_parse_nvidia_smi_rejects_malformed(bad):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(bad)


@pytest.mark.parametrize("kind", sorted(device.PEAKS))
def test_peak_table_rows(kind):
    p = device.peaks(kind)
    assert p.hbm_GBs > 0 and p.fp32_TFs > p.fp64_TFs > 0
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak table entry"):
        device.peaks(kind)


def _record_config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(device.jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_uses_env_var_as_is(monkeypatch, tmp_path):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself; nothing else is set


def test_compile_cache_fixed_repo_path_when_unset(monkeypatch):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.enable_compile_cache()
    assert first == os.path.join(REPO, ".jax_cache")
    assert device.enable_compile_cache() == first  # fixed, not per process
    assert calls == [("jax_compilation_cache_dir", first)] * 2
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_device_record_names_the_default_device():
    rec = device.device_record()
    dev = jax.devices()[0]
    assert rec == {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())}


# --- running the phases ----------------------------------------------------
def test_failing_phase_stops_the_run(capsys):
    ran = []

    def boom():
        raise cs.PhaseFailure("deliberate")

    rc = cs.run_phases([("a", lambda: ran.append("a")), ("b", boom),
                        ("c", lambda: ran.append("c"))])
    out = capsys.readouterr().out
    assert rc == 1 and ran == ["a"]
    assert "[b] FAILED" in out and '"ok"' not in out


def test_main_on_cpu_exits_nonzero_without_ok_line(monkeypatch, capsys):
    monkeypatch.setattr(device, "enable_compile_cache", lambda: "unused")
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "[device] FAILED" in out and '"ok"' not in out


def test_main_last_line_format(monkeypatch, capsys):
    smi = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(device, "enable_compile_cache", lambda: "unused")
    monkeypatch.setattr(cs, "phase_device", lambda cards: smi)
    for name in ("start_host_2d", "start_host_3d", "phase_goldens",
                 "phase_shearband2d", "phase_shearband3d", "phase_coupled",
                 "phase_xla_passes"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    fake = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(device, "device_record", lambda: fake)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": fake}
    assert lines[-2] == "nvidia-smi: " + smi


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu_or_package(tmp_path, alone):
    """As a user runs it: on a machine without a GPU, and from a directory
    that holds the script and nothing else of the repository."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    cwd = REPO
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        cwd = str(tmp_path)
        with open(script) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        script = str(tmp_path / "chip_smoke.py")
    p = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


# --- small helpers ----------------------------------------------------------
class _Info:
    def __init__(self, err, err1):
        self.err = np.asarray(err)
        self.err_history = np.asarray([err1, np.nan])


class _PT:
    eps_abs, eps_rel = 1e-8, 1e-6


@pytest.mark.parametrize("err, err1, ok", [
    (1e-9, 1.0, True),       # below eps_abs
    (5e-7, 1.0, True),       # below eps_rel relative to the first chunk
    (5e-6, 1.0, False),      # neither: stopped at iter_max
    (float("nan"), 1.0, False),
])
def test_stokes_converged(err, err1, ok):
    assert cs.stokes_converged(_Info(err, err1), _PT()) is ok


def test_hlo_permute_counts():
    hlo = """
  %cp = f64[4]{0} collective-permute(f64[4]{0} %a), source_target_pairs={{0,1}}
  %s = (f64[4]{0}, f64[4]{0}) collective-permute-start(f64[4]{0} %b)
  %d = f64[4]{0} collective-permute-done((f64[4]{0}, f64[4]{0}) %s)
"""
    assert cs._hlo_permutes(hlo) == {
        "collective-permute": 1, "collective-permute-start": 1,
        "collective-permute-done": 1}


# --- each phase at a tiny size ----------------------------------------------
def test_phase_goldens_small(capsys):
    cs.phase_goldens(names=["solcx"], dtypes=["float64"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[goldens] ") and '"pass": true' in line


def test_phase_shearband2d_small(clock, capsys):
    host = cs.start_host_2d(n=24, iters=20)
    cs.phase_shearband2d(host, n=16, nt=2, compile_clock=clock)
    out = capsys.readouterr().out
    assert out.count('"converged": true') == 2
    assert '"check": "card_vs_host"' in out


def test_phase_shearband3d_small(clock, capsys):
    host = cs.start_host_3d(n=8, iters=20)
    cs.phase_shearband3d(host, n=8, nt=1, compile_clock=clock)
    out = capsys.readouterr().out
    assert '"converged": true' in out and "memory_analysis" in out


def test_card_vs_host_catches_a_difference(clock):
    """The comparison fails when the two runs do not do the same work."""
    from justrelax_tpu.solvers.stokes2d_vep import solve_vep

    args, host = cs.start_host_2d(n=16, iters=20)
    st = args[0]
    moved = (st.replace(V=st.V.replace(Vx=st.V.Vx * 1.01)),) + args[1:]
    with pytest.raises(cs.PhaseFailure, match="card vs host"):
        cs.compare_card_host("t", solve_vep, moved, host, cs.FIELDS_2D,
                             clock)


def test_coupled_steps_small(clock, capsys):
    cs.coupled_steps(n=16, nt=2, compile_clock=clock)
    assert capsys.readouterr().out.count('"finite": true') == 2


def test_phase_xla_passes_small(capsys):
    cs.phase_xla_passes(n2d=16, n3d=8, copy_bytes=1 << 16, target_s=0.005)
    out = capsys.readouterr().out
    labels = [lab for lab, _, _ in cs.xla_pass_families()]
    for lab in labels:
        assert f'"family": "{lab}"' in out
    assert "copy_GBs" in out


def test_four_cards_2d_on_virtual_devices(clock, capsys):
    cs.four_cards_2d(n=16, iters=20, compile_clock=clock)
    out = capsys.readouterr().out
    assert '"check": "sharded_vs_serial"' in out


def test_four_cards_3d_on_virtual_devices(clock, capsys):
    cs.four_cards_3d(n_local=4, iters=20, compile_clock=clock)
    out = capsys.readouterr().out
    assert '"check": "sharded_vs_serial"' in out


@pytest.mark.gpu
def test_device_and_a_golden_on_the_card(gpu):
    """On a machine with a card: the device phase and the SolCx golden in
    f64 and f32 run there, in a child process that owns the card."""
    from conftest import card_env

    code = ("import chip_smoke as cs; cs.phase_device(); "
            "cs.phase_goldens(names=['solcx'])")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=card_env(), capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert '"platform": "gpu"' in p.stdout
