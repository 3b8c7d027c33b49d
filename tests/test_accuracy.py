"""Accuracy regression: the f32 flagship config vs f64 ground truth.

The shipped f32 config (two_level agg=48,
du_tol=inf, Newton rtol 1e-4 — `run.py`) was validated only for speed;
this pins its solution error against the f64 defaults (block-Jacobi,
Newton rtol 1e-6) on a matrix-3 transient.  Measured drift (CPU, 10
steps, matrix 3): see `benchlogs/accuracy_f32_vs_f64.txt`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
from navierstokes_tpu.mesh.box import scaling_series_mesh
from navierstokes_tpu.model import NavierStokesSolver


def _flagship_f32_cfg(n_steps: int, dt: float = 1e-3) -> NSConfig:
    """The run.py float32 defaults, verbatim (keep in sync with run.py)."""
    krylov = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                          neumann_order=0, preconditioner="two_level",
                          coarse_agg=48, spmv="plane")
    return NSConfig(
        dt=dt, t_final=n_steps * dt, reynolds=300.0, delta=0.05,
        dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov,
    )


def _f64_cfg(n_steps: int, dt: float = 1e-3) -> NSConfig:
    """The run.py float64 defaults (reference-grade tolerances)."""
    return NSConfig(
        dt=dt, t_final=n_steps * dt, reynolds=300.0, delta=0.05,
        dtype="float64",
        newton=NewtonConfig(),
        krylov=SolverConfig(),
        stokes_krylov=SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000),
    )


@pytest.mark.slow
def test_f32_flagship_matches_f64_ground_truth():
    n_steps = 10
    mesh = scaling_series_mesh(3)  # 1458 nodes, 5832 DoF

    s64 = NavierStokesSolver(mesh, _f64_cfg(n_steps))
    u64 = np.asarray(s64.run(n_steps, u0=s64.stokes_init()), dtype=np.float64)

    s32 = NavierStokesSolver(mesh, _flagship_f32_cfg(n_steps))
    u32 = np.asarray(s32.run(n_steps, u0=s32.stokes_init()), dtype=np.float64)

    assert np.all(np.isfinite(u32))
    drift = np.linalg.norm(u32 - u64) / np.linalg.norm(u64)
    print(f"matrix 3, {n_steps} steps: rel L2 drift f32-flagship vs f64 = "
          f"{drift:.3e}")
    # The flagship truncates Newton at rtol 1e-4 and runs f32 — a few e-4
    # relative drift is the expected cost; 5e-3 flags a real regression.
    assert drift < 5e-3


@pytest.mark.slow
def test_f32_drift_matrix4_bounded_and_non_secular():
    """Matrix 4 is the worst measured drift point (round 3: 1.8e-3 at 10
    steps, 80x matrix 3); the round-4 100-step curve showed it PEAKS at
    step 1 and decays (benchlogs/accuracy_f32_vs_f64.txt).  Guard both the
    bound and the trend: drift at step 12 must not exceed the early-step
    drift by more than 50% (measured ratio: 1.8e-3 / 2.3e-3 = 0.79)."""
    from navierstokes_tpu.bench.accuracy_drift import run_drift

    rows = run_drift(4, 12, 1e-3)
    d = dict(rows)
    print(f"matrix 4 drift curve: {rows}")
    assert max(d.values()) < 8e-3, d           # bound (curve max: 3.0e-3)
    assert d[12] < 1.5 * d[3], d               # non-secular trend
