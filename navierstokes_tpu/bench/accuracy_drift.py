"""Long-horizon f32-vs-f64 drift curve.

The reference's headline artifact is a 1000-step double-precision corpus
(`res/solution_step0001.dat`, params `src/solve_newton-petsc.c:663-667`);
the repo's flagship runs float32.  This driver runs the f32 flagship config
and the f64 reference-grade config SIDE BY SIDE over many steps and prints
the relative L2 drift at log-spaced checkpoints — the trend (secular growth
vs saturation) is what `tests/test_accuracy.py` guards.

Usage (CPU — the f64 path is CPU-grade precision anyway):
    python -m navierstokes_tpu.bench.accuracy_drift --matrix-id 3 \
        [--steps 100] [--dt 1e-3]

Prints one line per checkpoint:
    DRIFT id=3 step=20 t=0.020 rel_l2=1.23e-04 newton32=2 lin32=40
and a final summary line:
    DRIFT_SUMMARY id=3 steps=100 first=... last=... max=... ratio_last10=...
"""

from __future__ import annotations

import argparse
import sys


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _checkpoints(n: int):
    pts = sorted({1, 2, 3, 5, 7, 10, 15, 20, 30, 50, 70, 100, 150, 200,
                  300, 500, 700, 1000} | {n})
    return [p for p in pts if p <= n]


def run_drift(matrix_id: int, steps: int, dt: float):
    import jax.numpy as jnp
    import numpy as np

    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = scaling_series_mesh(matrix_id)

    # run.py f32 defaults (two_level + plane + auto agg schedule)
    kr32 = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                        neumann_order=0, preconditioner="two_level",
                        spmv="plane")
    cfg32 = NSConfig(
        dt=dt, t_final=steps * dt, reynolds=300.0, delta=0.05,
        dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=kr32, stokes_krylov=kr32,
    )
    # run.py f64 defaults (reference-grade tolerances)
    cfg64 = NSConfig(
        dt=dt, t_final=steps * dt, reynolds=300.0, delta=0.05,
        dtype="float64",
        newton=NewtonConfig(),
        krylov=SolverConfig(),
        stokes_krylov=SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000),
    )

    s32 = NavierStokesSolver(mesh, cfg32)
    s64 = NavierStokesSolver(mesh, cfg64)
    log(f"mesh: {mesh.nv} nodes ({mesh.ndof} rows), {mesh.ne} tets")

    u32 = s32.stokes_init()
    u64 = s64.stokes_init()
    d32 = jnp.zeros_like(u32)
    d64 = jnp.zeros_like(u64)
    uo32, uo64 = u32, u64

    marks = set(_checkpoints(steps))
    rows = []
    for k in range(1, steps + 1):
        u32n, d32, st32 = s32.step(u32, uo32, d32)
        u64n, d64, st64 = s64.step(u64, uo64, d64)
        uo32, uo64 = u32, u64
        u32, u64 = u32n, u64n
        if k in marks:
            a = np.asarray(u32, dtype=np.float64)
            b = np.asarray(u64)
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            rows.append((k, rel))
            print(
                f"DRIFT id={matrix_id} step={k} t={k * dt:.3f} "
                f"rel_l2={rel:.3e} newton32={int(st32.iters)} "
                f"lin32={int(st32.lin_iters)} newton64={int(st64.iters)}",
                flush=True,
            )
            if not np.isfinite(rel):
                break

    ks = [r[0] for r in rows]
    vals = [r[1] for r in rows]
    # growth over the last decade of steps: drift(end) / drift(end/10) —
    # ~1 means saturated, >>1 means secular growth
    import bisect
    i10 = bisect.bisect_left(ks, max(ks[-1] // 10, 1))
    ratio = vals[-1] / vals[i10] if vals[i10] > 0 else float("inf")
    print(
        f"DRIFT_SUMMARY id={matrix_id} steps={ks[-1]} first={vals[0]:.3e} "
        f"last={vals[-1]:.3e} max={max(vals):.3e} "
        f"growth_last_decade={ratio:.2f}x",
        flush=True,
    )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--dt", type=float, default=1e-3)
    args = p.parse_args(argv)
    # Always CPU + x64: a long f64 ground-truth leg is a host-side job.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    run_drift(args.matrix_id, args.steps, args.dt)


if __name__ == "__main__":
    main()
