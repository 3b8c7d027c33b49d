"""Contract tests for the externally-checked driver artifacts.

Two entry points are run outside the test suite: `python bench.py` on the
GPU and `dryrun_multichip(8)`.  These tests run the same code paths
end-to-end on CPU so a crash cannot reach a run unexercised:

- `bench.py --smoke --cpu` drives EVERY benchmarked SpMV path (XLA DIA,
  plane-major, block-ELL) plus the flagship solver step on a tiny mesh,
  and must print one parseable JSON line with the full field contract.
- `__graft_entry__.dryrun_multichip(8)` runs in-process on the 8 virtual
  CPU devices the conftest provides; `entry()` must trace/lower.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REQUIRED_FIELDS = {
    "metric", "value", "unit", "vs_baseline",
    "step_ms_121k", "newton_iters", "lin_iters", "device",
}


@pytest.mark.slow
def test_bench_smoke_json_contract():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "bench.py", "--smoke", "--cpu"],
        capture_output=True, text=True, timeout=1200, cwd=REPO, env=env,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"bench.py must print ONE line, got: {lines}"
    payload = json.loads(lines[0])
    missing = REQUIRED_FIELDS - payload.keys()
    assert not missing, f"JSON line missing fields: {missing}"
    assert payload["value"] > 0 and payload["vs_baseline"] > 0
    assert payload["newton_iters"] >= 1 and payload["lin_iters"] >= 1
    assert payload["step_ms_121k"] > 0


@pytest.mark.slow
def test_graft_entry_compiles_and_dryrun_runs():
    import jax

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as ge
    finally:
        sys.path.remove(REPO)

    fn, args = ge.entry()
    jax.jit(fn).lower(*args)  # the driver's single-chip compile check

    # conftest already initialized the CPU backend with 8 virtual devices,
    # so dryrun_multichip takes its already-initialized branch.
    ge.dryrun_multichip(8)
