"""Benchmark on the GPU: per-kernel-family T_eff / GUPS and golden checks.

The APT method is memory-bandwidth bound (Räss et al. 2022 GMD; reference
docs/src/man/equations_APT.md:38): the per-device figure of merit is T_eff —
the necessary memory traffic of one fused PT iteration divided by its wall
time — against the device's memory bandwidth, plus grid-updates/s. BASELINE.md
requires this *per kernel family*; the families and their Räss-convention
traffic accounting live in justrelax_tpu/utils/bench_kernels.py.

The default device must be a GPU whose ``device_kind`` is in the peak table
(justrelax_tpu/utils/device.py); anything else stops the run. Times end in
``block_until_ready``; t_iter is the slope between two trip counts of one
compiled step. Each family's stream rate is also given as a share of a large
copy measured in the same run.

Record keeping:
- goldens run FIRST (justrelax_tpu/utils/goldens.py, f64 and f32);
- every completed item is appended at once to BENCH_partial.jsonl (and a
  progress line goes to stderr), so a kill at any point leaves a record;
- a failing golden or family is recorded as its row and the run goes on;
  the process then exits 1 after printing the final JSON line.

Prints ONE JSON line. Headline metric = 2D VEP (flagship) T_eff at 4096²
f32; vs_baseline = T_eff / the device's HBM peak.

Env overrides: BENCH_FAMILIES=ve2d,vep2d,...  BENCH_GOLDENS=default|off
BENCH_REPEATS=3
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import jax

PARTIAL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_partial.jsonl")


def _progress(section, name, row):
    """Append one completed item to the partial record and stderr — a later
    crash/kill can never erase it."""
    line = json.dumps({"section": section, "name": name, "row": row})
    try:
        with open(PARTIAL_PATH, "a") as f:
            f.write(line + "\n")
    except OSError:
        pass
    print(f"[bench] {section}:{name} -> {line[:400]}", file=sys.stderr,
          flush=True)


def _err_tail(exc, n=900):
    s = f"{type(exc).__name__}: {exc}"
    return s[-n:]


def run_goldens(level="default"):
    """The shared golden solves on the default device, f64 and f32. A
    golden that raises is recorded as failed and the rest still run."""
    from justrelax_tpu.utils.goldens import DTYPES, GOLDENS, run_golden

    out = {}
    if level == "off":
        return out
    for name in GOLDENS:
        for dtype in DTYPES:
            key = f"{name}_{dtype}"
            try:
                out[key] = run_golden(name, dtype)
            except Exception as exc:
                traceback.print_exc(file=sys.stderr)
                out[key] = {"pass": False, "error": _err_tail(exc)}
            _progress("goldens", key, out[key])
    return out


DEFAULT_FAMILIES = (
    "ve2d,vep2d,thermal2d,thermal3d,ve3d,ve3d_canvas,vep3d,vep3d_canvas"
)


def main():
    from justrelax_tpu.utils import device
    from justrelax_tpu.utils.bench_kernels import measure_family
    from justrelax_tpu.utils.timing import copy_rate

    families = os.environ.get("BENCH_FAMILIES", DEFAULT_FAMILIES)
    families = [f for f in families.split(",") if f]
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    golden_level = os.environ.get("BENCH_GOLDENS", "default")

    dev = device.require_gpu()
    peak = device.peaks(dev.device_kind)
    device.enable_compile_cache()
    jax.config.update("jax_enable_x64", True)  # the f64 goldens
    card = device.nvidia_smi()

    try:
        os.remove(PARTIAL_PATH)
    except OSError:
        pass

    # goldens FIRST: the correctness record survives any later perf failure
    goldens = run_goldens(golden_level)

    results = {}
    with jax.enable_x64(False):  # the families are f32
        copy_Bs = copy_rate()
        _progress("copy", "copy_1GiB", {"GBs": copy_Bs / 1e9})
        for fam in families:
            try:
                row = measure_family(fam, copy_Bs, target_s=0.6,
                                     repeats=repeats)
                row["vs_hbm_peak"] = row["T_eff_GBs"] / peak.hbm_GBs
                results[fam] = row
            except Exception as exc:
                traceback.print_exc(file=sys.stderr)
                results[fam] = {"error": _err_tail(exc)}
            _progress("families", fam, results[fam])

    head = results.get("vep2d", {})
    payload = {
        "metric": "vep2d_T_eff",
        "value": head.get("T_eff_GBs"),
        "unit": "GB/s",
        "vs_baseline": head.get("vs_hbm_peak"),
        "copy_GBs": copy_Bs / 1e9,
        "peak": peak._asdict(),
        "families": results,
        "goldens": goldens,
        "goldens_all_pass": all(g["pass"] for g in goldens.values())
        if goldens else None,
        "device": device.device_record(),
        "nvidia_smi": device.parse_nvidia_smi(card),
    }
    print(json.dumps(payload))
    failed = ([k for k, g in goldens.items() if not g["pass"]]
              + [k for k, r in results.items() if "error" in r])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
