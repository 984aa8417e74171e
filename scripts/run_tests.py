"""Per-file test runner with worker isolation — the repo's analogue of the
reference's ParallelTestRunner (test/runtests.jl:29-38).

Why not one `pytest tests/`: a single 289-test process compiles thousands of
XLA programs; one flaky XLA-CPU compiler segfault then kills the whole
30-minute run (observed once at test 271). Here every test FILE runs in its
own subprocess, so a crash costs one file, is reported as such, and is
retried once solo (that segfault passed cleanly on retry).

Usage:
    python scripts/run_tests.py            # all tests/test_*.py, 2 workers
    python scripts/run_tests.py -j 4       # 4 parallel workers
    python scripts/run_tests.py -k vep3d   # only files whose name matches

Workers default to 2: the 8-device virtual-mesh tests are CPU-hungry, and
oversubscription inflates the wall clock badly.

The test processes run on the CPU only (tests/conftest.py forces
``JAX_PLATFORMS=cpu``); this runner never starts processes on a GPU, where
one JAX process per card is the rule.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_file(path: str, timeout: int) -> dict:
    """Run one test file in a fresh subprocess; retry once on a crash
    (negative returncode = killed by signal, e.g. an XLA compiler segfault)."""
    cmd = [sys.executable, "-m", "pytest", path, "-q", "--no-header"]
    for attempt in (1, 2):
        t0 = time.time()
        try:
            p = subprocess.run(
                cmd, cwd=REPO, capture_output=True, text=True,
                timeout=timeout,
            )
        except subprocess.TimeoutExpired:
            return {"file": path, "status": "timeout", "rc": None,
                    "secs": round(time.time() - t0, 1), "tail": ""}
        secs = round(time.time() - t0, 1)
        tail = "\n".join((p.stdout + p.stderr).splitlines()[-12:])
        if p.returncode == 0:
            status = "pass" if attempt == 1 else "pass-on-retry"
            return {"file": path, "status": status, "rc": 0, "secs": secs,
                    "tail": tail}
        if p.returncode < 0 and attempt == 1:
            # crashed (signal): isolate + retry once, like the reference
            # re-runs flaky workers
            continue
        if p.returncode == 5:  # pytest: no tests collected (e.g. -k filter)
            return {"file": path, "status": "no-tests", "rc": 5,
                    "secs": secs, "tail": ""}
        return {"file": path, "status": "fail", "rc": p.returncode,
                "secs": secs, "tail": tail}
    return {"file": path, "status": "crash", "rc": p.returncode,
            "secs": secs, "tail": tail}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-j", "--jobs", type=int, default=2)
    ap.add_argument("-k", "--keyword", default="")
    ap.add_argument("--timeout", type=int, default=3600,
                    help="per-file timeout in seconds")
    args = ap.parse_args()

    tdir = os.path.join(REPO, "tests")
    files = sorted(
        os.path.join("tests", f) for f in os.listdir(tdir)
        if f.startswith("test_") and f.endswith(".py")
        and args.keyword in f
    )
    if not files:
        print("no test files matched", file=sys.stderr)
        return 2

    t0 = time.time()
    results = []
    with cf.ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(run_file, f, args.timeout): f for f in files}
        for fut in cf.as_completed(futs):
            r = fut.result()
            results.append(r)
            mark = {"pass": ".", "pass-on-retry": "R", "no-tests": "-",
                    "fail": "F", "crash": "C", "timeout": "T"}[r["status"]]
            print(f"[{mark}] {r['file']:<46} {r['secs']:>7}s  {r['status']}",
                  flush=True)
            if r["status"] in ("fail", "crash", "timeout"):
                print(r["tail"], flush=True)

    bad = [r for r in results if r["status"] in ("fail", "crash", "timeout")]
    retried = [r for r in results if r["status"] == "pass-on-retry"]
    print(f"\n{len(results)} files, {len(bad)} failed, "
          f"{len(retried)} passed-on-retry, "
          f"{round(time.time() - t0, 1)}s total")
    for r in bad:
        print(f"  FAILED: {r['file']} ({r['status']})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
