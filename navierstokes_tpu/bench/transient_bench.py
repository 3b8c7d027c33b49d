"""End-to-end transient step benchmark over the scaling-series meshes.

The solver-level analog of `spmv_bench`: per-step wall time of the jitted
Newton step with the run.py f32 defaults (or any knob overridden on the
command line), with per-phase setup timing.  The reference's corresponding
artifact is the completed mmesh run behind `res/solution_step*.dat` plus the
per-phase `-log_view` output (`src/solve_newton.c:1290-1310`).

Usage:
    python -m navierstokes_tpu.bench.transient_bench --matrix-id 8 \
        [--steps 5] [--coarse-agg 48] [--coarse-ml-smooth 2] \
        [--coarse-ml-cycles 1] [--preconditioner two_level] [--restart 30]

Prints one summary line per run:
    TRANSIENT id=8 ndof=511024 setup_s=... stokes_s=... compile_s=... \
        step_ms=... newton=N lin=M cfg=...
"""

from __future__ import annotations

import argparse
import sys
import time


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _live_hbm_mb() -> float:
    """Sum of live device-array bytes (standing HBM inventory)."""
    import jax

    try:
        return sum(a.nbytes for a in jax.live_arrays()) / 1e6
    except Exception:
        return float("nan")


def run_one(matrix_id: int, steps: int, overrides: dict,
            mesh=None, disc=None, release: bool = False,
            skip_stokes: bool = False) -> dict:
    import jax.numpy as jnp

    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    # coarse_agg=None = the measured per-size auto schedule (config.
    # auto_coarse_agg: 48/128/256).  The base pins preconditioner=
    # "two_level" — the historical flagship — so its rows stay comparable;
    # the PRODUCT default is preconditioner="auto" (run.default_f32_krylov),
    # whose per-size winners are measured as overrides against this base.
    base = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                        neumann_order=0, preconditioner="two_level",
                        spmv="plane")
    import dataclasses
    krylov = dataclasses.replace(base, **overrides) if overrides else base
    # stokes keeps the BASE tolerances/method so solver-method overrides
    # (restart, ca_gmres, ...) don't change the initial condition.  NOTE:
    # preconditioner-structure knobs still apply to stokes too — the prep
    # is built from cfg.krylov (see model._prepare_operator_dia).
    cfg = NSConfig(
        dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=base,
    )

    if mesh is None:
        mesh = scaling_series_mesh(matrix_id)
    t0 = time.perf_counter()
    solver = NavierStokesSolver(mesh, cfg, disc=disc)
    solver._ensure_prepared()
    setup_s = time.perf_counter() - t0
    log(f"id={matrix_id} ndof={solver.disc.ndof} setup {setup_s:.1f} s")

    t0 = time.perf_counter()
    if skip_stokes:
        u = jnp.zeros(solver.disc.ndof, solver.dtype)
        stokes_s = 0.0
        log("stokes skipped (zero init)")
    else:
        u = solver.stokes_init()
        u.block_until_ready()
        stokes_s = time.perf_counter() - t0
        log(f"stokes init {stokes_s:.1f} s (incl compile)")
    if release:
        # Free assembly-time buffers (geometry + multi-GB scatter map) —
        # required headroom for the 2.35M-row step on one 16 GB chip.
        solver.release_assembly_buffers()
        log(f"assembly buffers released; live HBM {_live_hbm_mb():.0f} MB")

    u_old, du = u, jnp.zeros_like(u)
    log(f"live HBM before step: {_live_hbm_mb():.0f} MB")
    t0 = time.perf_counter()
    u1, du1, stats = solver.step(u, u_old, du)
    u1.block_until_ready()
    compile_s = time.perf_counter() - t0
    log(f"step 1 (incl compile) {compile_s:.1f} s "
        f"newton={int(stats.iters)} lin={int(stats.lin_iters)}")

    # Backward-Euler advance: the PREVIOUS TIME SOLUTION is both the Newton
    # initial guess and u_old, exactly as model.run() does.  (An earlier
    # version passed the state from two steps back as u_old, which re-solved
    # the already-converged interval on alternating calls — halving apparent
    # step cost.)
    u_cur, du_cur = u1, du1
    per_step = []          # device scalars; fetched after the final sync
    t0 = time.perf_counter()
    for _ in range(steps):
        u_cur, du_cur, stats = solver.step(u_cur, u_cur, du_cur)
        per_step.append(stats)
    u_cur.block_until_ready()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    import numpy as np

    assert np.all(np.isfinite(np.asarray(u_cur))), "non-finite state"
    counts = [(int(s.iters), int(s.lin_iters)) for s in per_step]
    mean_lin = sum(l for _, l in counts) / max(len(counts), 1)
    # step_ms is a MEAN over steps whose iteration counts can differ a lot
    # (the first post-compile steps are still relaxing the Stokes initial
    # condition); ms/iter must divide by the MEAN lin count, not the last
    # step's, which can be far from the mean.
    log("per-step (newton, lin): " + " ".join(map(str, counts))
        + f"; mean lin {mean_lin:.1f}"
        + (f"; ms/lin-iter {step_ms / mean_lin:.2f}" if mean_lin else ""))
    result = {
        "id": matrix_id, "ndof": solver.disc.ndof,
        "setup_s": round(setup_s, 1), "stokes_s": round(stokes_s, 1),
        "compile_s": round(compile_s, 1), "step_ms": round(step_ms, 1),
        "newton": int(stats.iters), "lin": int(stats.lin_iters),
        "mean_lin": round(mean_lin, 1),
    }
    cfg_str = ",".join(f"{k}={v}" for k, v in sorted(overrides.items())) or \
        "defaults"
    print("TRANSIENT " +
          " ".join(f"{k}={v}" for k, v in result.items()) +
          f" cfg={cfg_str}", flush=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, required=True)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--preconditioner", default=None)
    p.add_argument("--coarse-agg", type=int, default=None)
    p.add_argument("--coarse-ml-smooth", type=int, default=None)
    p.add_argument("--coarse-ml-cycles", type=int, default=None)
    p.add_argument("--coarse-ml-damp", type=float, default=None)
    p.add_argument("--coarse-dense-max", type=int, default=None)
    p.add_argument("--coarse-smooth-omega", type=float, default=None)
    p.add_argument("--coarse-basis", default=None,
                   choices=["const", "linear"])
    p.add_argument("--coarse-cheby", type=int, default=None)
    p.add_argument("--coarse-cheby-fraction", type=float, default=None)
    p.add_argument("--schur-cheby", type=int, default=None)
    p.add_argument("--schur-v-cheby", type=int, default=None)
    p.add_argument("--schur-shape", default=None,
                   choices=["lower", "full"])
    p.add_argument("--restart", type=int, default=None)
    p.add_argument("--spmv", default=None,
                   choices=["auto", "xla", "plane"])
    p.add_argument("--neumann-order", type=int, default=None)
    p.add_argument("--deflation-k", type=int, default=None)
    p.add_argument("--deflation-arnoldi", type=int, default=None)
    p.add_argument("--method", default=None,
                   choices=["gmres", "ca_gmres", "cg"])
    p.add_argument("--release", action="store_true",
                   help="free assembly buffers after stokes (matrix-10 "
                        "memory diet; incompatible with --sweep, which "
                        "reuses the discretization)")
    p.add_argument("--skip-stokes", action="store_true",
                   help="zero initial condition (probing large meshes)")
    p.add_argument("--disc-cache", default=None,
                   help="directory to save/load the pickled discretization "
                        "(host pattern build takes ~10-20 min at 2.35M rows)")
    p.add_argument("--sweep", default=None,
                   help="semicolon-separated override sets, each "
                        "'key=val,key=val' (keys as the flags, underscored); "
                        "all runs share ONE discretization so host setup is "
                        "paid once, e.g. --sweep 'coarse_ml_smooth=2;"
                        "coarse_agg=64,coarse_dense_max=16384'")
    args = p.parse_args(argv)
    overrides = {
        k: v for k, v in (
            ("preconditioner", args.preconditioner),
            ("coarse_agg", args.coarse_agg),
            ("coarse_ml_smooth", args.coarse_ml_smooth),
            ("coarse_ml_cycles", args.coarse_ml_cycles),
            ("coarse_ml_damp", args.coarse_ml_damp),
            ("coarse_dense_max", args.coarse_dense_max),
            ("coarse_smooth_omega", args.coarse_smooth_omega),
            ("coarse_basis", args.coarse_basis),
            ("coarse_cheby", args.coarse_cheby),
            ("coarse_cheby_fraction", args.coarse_cheby_fraction),
            ("schur_cheby", args.schur_cheby),
            ("schur_v_cheby", args.schur_v_cheby),
            ("schur_shape", args.schur_shape),
            ("deflation_k", args.deflation_k),
            ("deflation_arnoldi", args.deflation_arnoldi),
            ("restart", args.restart),
            ("spmv", args.spmv),
            ("neumann_order", args.neumann_order),
            ("method", args.method),
        ) if v is not None
    }
    import os

    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        build_discretization,
        load_discretization,
        save_discretization,
    )
    from navierstokes_tpu.mesh.box import scaling_series_mesh

    mesh = disc = None
    if args.disc_cache:
        if os.path.exists(f"{args.disc_cache}/mesh.pkl"):
            t0 = time.perf_counter()
            disc = load_discretization(args.disc_cache, dtype=jnp.float32)
            mesh = disc.mesh
            log(f"disc cache loaded in {time.perf_counter() - t0:.1f} s "
                f"(ndof={disc.ndof})")
        else:
            mesh = scaling_series_mesh(args.matrix_id)
            t0 = time.perf_counter()
            disc = build_discretization(mesh, dtype=jnp.float32)
            log(f"disc built in {time.perf_counter() - t0:.1f} s; saving")
            save_discretization(disc, args.disc_cache)

    if args.sweep is None:
        run_one(args.matrix_id, args.steps, overrides, mesh=mesh, disc=disc,
                release=args.release, skip_stokes=args.skip_stokes)
        return

    def parse_val(s):
        try:
            return int(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return s

    if disc is None:
        mesh = scaling_series_mesh(args.matrix_id)
        t0 = time.perf_counter()
        disc = build_discretization(mesh, dtype=jnp.float32)
        log(f"shared discretization built in {time.perf_counter() - t0:.1f} s")
    for chunk in args.sweep.split(";"):
        ov = dict(overrides)
        if chunk.strip():
            for kv in chunk.split(","):
                k, v = kv.split("=")
                ov[k.strip()] = parse_val(v.strip())
        try:
            run_one(args.matrix_id, args.steps, ov, mesh=mesh, disc=disc)
        except Exception as e:  # record and continue the sweep
            print(f"TRANSIENT id={args.matrix_id} FAILED cfg={chunk}: {e!r}",
                  flush=True)


if __name__ == "__main__":
    main()
