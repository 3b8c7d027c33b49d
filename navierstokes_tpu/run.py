"""Transient Navier-Stokes CLI — the `solve_newton` main() equivalent.

The reference CLI (`src/solve_newton.c:925-1323`): `-msh <file> [-avx2]
[-save]` with physics constants hardcoded.  Here everything is a flag:

    python -m navierstokes_tpu.run --msh mesh.msh --save
    python -m navierstokes_tpu.run --matrix-id 6 --re 300 --dt 1e-3 \
        --t-final 1.0 --delta 0.05 --save --save-dir res --vtu
    python -m navierstokes_tpu.run --matrix-id 3 --devices 4   # multi-chip

Per-step output mirrors the reference Newton monitor; `--save` writes
PETSc-ASCII `res/solution_stepNNNN.dat` byte-compatible with the golden
corpus; `--checkpoint`/`--resume` give real restart capability (which the
reference lacks).
"""

from __future__ import annotations

import argparse
import sys
import time


def default_f32_krylov():
    """The flagship f32 Krylov defaults (single source of truth: run.py's
    f32 path, chip_smoke.py AND `__graft_entry__.dryrun_multichip` assert
    against this).  coarse_agg stays None = the per-size auto schedule
    (config.auto_coarse_agg), and preconditioner="auto" = the per-size
    preconditioner schedule (config.auto_preconditioner: two_level +
    coarse_cheby=3 at mmesh scale, pressure-Schur + velocity-Chebyshev
    above)."""
    from navierstokes_tpu.config import SolverConfig

    return SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                        neumann_order=0, preconditioner="auto",
                        spmv="plane")


def main(argv=None):
    p = argparse.ArgumentParser(description="Transient Navier-Stokes solver")
    p.add_argument("--msh", help="Gmsh 2.2 mesh file")
    p.add_argument("--matrix-id", type=int,
                   help="synthetic scaling-series mesh 1-10")
    p.add_argument("--nx", type=int, help="custom channel mesh nx")
    p.add_argument("--ny", type=int, default=None)
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--obstacle", action="store_true")
    p.add_argument("--re", type=float, default=300.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--t-final", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=None,
                   help="override number of steps")
    p.add_argument("--delta", type=float, default=0.05)
    p.add_argument("--dtype", default=None,
                   help="float32 (accelerator default) / float64 (CPU "
                        "default)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--save", action="store_true")
    p.add_argument("--save-dir", default="res")
    p.add_argument("--save-every", type=int, default=1)
    p.add_argument("--vtu", action="store_true", help="also write .vtu/.pvd")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--devices", type=int, default=0,
                   help=">1: distributed solver over this many devices")
    p.add_argument("--profile", action="store_true",
                   help="print an event-log report at the end")
    # Perf knobs (the `-matmult_variant`/`-avx2` analog,
    # `src/kernels/variant_selector.c:3-15`): sweepable without code edits.
    p.add_argument("--spmv", choices=["auto", "xla", "plane"], default=None,
                   help="SpMV kernel routing (default: auto)")
    p.add_argument("--preconditioner", default=None,
                   choices=["auto", "block_jacobi", "two_level", "schur",
                            "ilu0", "none"],
                   help="auto (the f32 default) = the measured per-size "
                        "schedule: two_level+coarse_cheby=3 at <=150k rows, "
                        "schur+schur_v_cheby=2 above (single-chip; "
                        "distributed degrades to two_level)")
    p.add_argument("--coarse-agg", type=int, default=None,
                   help="two_level: nodes per aggregate")
    p.add_argument("--coarse-ml-smooth", type=int, default=None,
                   help="multilevel coarse: smoothing sweeps per cycle")
    p.add_argument("--coarse-ml-cycles", type=int, default=None,
                   help="multilevel coarse: two-grid cycles per apply")
    p.add_argument("--coarse-ml-damp", type=float, default=None,
                   help="damping for the level-1 Jacobi sweeps (undamped "
                        "diverges on the saddle-point coarse system)")
    p.add_argument("--coarse-smooth-omega", type=float, default=None,
                   help="smoothed-aggregation prolongator damping "
                        "(0 = plain aggregation; dense coarse only)")
    p.add_argument("--coarse-basis", default=None,
                   choices=["const", "linear"],
                   help="coarse basis per aggregate: piecewise-constant "
                        "or orthonormalized {1,x,y,z} (plane mode only)")
    p.add_argument("--coarse-cheby", type=int, default=None,
                   help="two_level post-smoother: degree-d Chebyshev sweep "
                        "in D^{-1}A (0 = one damped-Jacobi application)")
    p.add_argument("--coarse-cheby-fraction", type=float, default=None,
                   help="lower end of the Chebyshev smoothing interval as "
                        "a fraction of lmax")
    p.add_argument("--schur-cheby", type=int, default=None,
                   help="schur: Chebyshev degree of the S_hat smoother "
                        "(0 = one Jacobi application)")
    p.add_argument("--schur-v-cheby", type=int, default=None,
                   help="schur: Chebyshev degree of the velocity smoother "
                        "(0 = one block-Jacobi application)")
    p.add_argument("--schur-shape", default=None,
                   choices=["lower", "full"],
                   help="schur: block-triangular shape (full adds the "
                        "B^T velocity correction)")
    p.add_argument("--neumann-order", type=int, default=None,
                   help="Neumann-series boost of block-Jacobi")
    p.add_argument("--deflation-k", type=int, default=None,
                   help="GCRO recycled-subspace size (harmonic Ritz "
                        "vectors of the constant preconditioned operator; "
                        "0 = off)")
    p.add_argument("--deflation-arnoldi", type=int, default=None,
                   help="Arnoldi length for the recycle setup (0 = auto)")
    p.add_argument("--ca-gmres", action="store_true",
                   help="use the s-step (communication-avoiding) GMRES")
    p.add_argument("--ca-basis", default=None,
                   choices=["monomial", "newton"],
                   help="ca_gmres basis: monomial or Leja-ordered Newton "
                        "(shifted) — the f32-stable choice")
    p.add_argument("--restart", type=int, default=None,
                   help="GMRES restart length")
    args = p.parse_args(argv)

    import jax

    from navierstokes_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    backend = jax.default_backend()
    dtype = args.dtype or ("float64" if backend == "cpu" else "float32")
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import channel_mesh, scaling_series_mesh
    from navierstokes_tpu.mesh.gmsh import read_gmsh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.utils.profiling import event_log

    if args.msh:
        mesh = read_gmsh(args.msh)
    elif args.matrix_id:
        mesh = scaling_series_mesh(args.matrix_id)
    elif args.nx:
        mesh = channel_mesh(
            args.nx, args.ny or args.nx // 2, args.nz or args.ny or args.nx // 2,
            obstacle=args.obstacle,
        )
    else:
        p.error("one of --msh / --matrix-id / --nx required")

    if dtype == "float32":
        # du_tol=inf: with the linear residual, the |F| criterion alone
        # determines convergence; the |du| test only adds Newton iterations
        # whose updates are already below tolerance.
        newton = NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                              du_tol=float("inf"))
        # Component-plane layout + the per-size preconditioner and
        # aggregate schedules (config.auto_preconditioner /
        # auto_coarse_agg).
        krylov = default_f32_krylov()
        stokes = default_f32_krylov()
    else:
        newton = NewtonConfig()
        krylov = SolverConfig()
        stokes = SolverConfig(rtol=1e-12, atol=1e-12, maxiter=2000)

    # Apply CLI perf-knob overrides to both Krylov configs.
    import dataclasses as _dc

    overrides = {}
    for field, value in (
        ("spmv", args.spmv),
        ("preconditioner", args.preconditioner),
        ("coarse_agg", args.coarse_agg),
        ("coarse_ml_smooth", args.coarse_ml_smooth),
        ("coarse_ml_cycles", args.coarse_ml_cycles),
        ("coarse_ml_damp", args.coarse_ml_damp),
        ("coarse_smooth_omega", args.coarse_smooth_omega),
        ("coarse_basis", args.coarse_basis),
        ("coarse_cheby", args.coarse_cheby),
        ("coarse_cheby_fraction", args.coarse_cheby_fraction),
        ("ca_basis", args.ca_basis),
        ("schur_cheby", args.schur_cheby),
        ("schur_v_cheby", args.schur_v_cheby),
        ("schur_shape", args.schur_shape),
        ("neumann_order", args.neumann_order),
        ("deflation_k", args.deflation_k),
        ("deflation_arnoldi", args.deflation_arnoldi),
        ("restart", args.restart),
    ):
        if value is not None:
            overrides[field] = value
    if args.ca_gmres:
        overrides["method"] = "ca_gmres"
    if overrides:
        krylov = _dc.replace(krylov, **overrides)
        stokes = _dc.replace(stokes, **overrides)

    cfg = NSConfig(
        dt=args.dt, t_final=args.t_final, reynolds=args.re, delta=args.delta,
        dtype=dtype, newton=newton, krylov=krylov, stokes_krylov=stokes,
    )
    n_steps = args.steps if args.steps is not None else cfg.n_steps

    print(f"Matrix size : {4 * mesh.nv}")
    print(f"backend={backend} dtype={dtype} nodes={mesh.nv} tets={mesh.ne}")

    if args.devices > 1:
        from navierstokes_tpu.parallel import DistributedNavierStokesSolver

        solver, _ = DistributedNavierStokesSolver.from_mesh(
            mesh, cfg, devices=jax.devices()[: args.devices]
        )
    else:
        with event_log.event("setup"):
            solver = NavierStokesSolver(mesh, cfg)

    u0 = None
    start_step = 0
    delta_u0 = None
    if args.resume:
        from navierstokes_tpu.io.checkpoint import load_checkpoint

        # cfg here is the user-level (pre-resolution) config — the same form
        # run() fingerprints checkpoints with (see NavierStokesSolver.run).
        start_step, u, u_old, delta_u = load_checkpoint(args.resume, cfg=cfg)
        print(f"resumed from step {start_step}")
        u0 = jnp.asarray(u)
        delta_u0 = jnp.asarray(delta_u)
    else:
        print("Solving Stokes system...")
        with event_log.event("stokes_init"):
            u0 = solver.stokes_init()
            u0.block_until_ready()

    t0 = time.time()
    with event_log.event("time_loop"):
        u = solver.run(
            max(n_steps - start_step, 0),
            u0=u0,
            save_dir=args.save_dir if args.save else None,
            save_every=args.save_every if args.save else 0,
            write_vtu_files=args.vtu,
            monitor=True,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            start_step=start_step,
            delta_u0=delta_u0,
        )
    print(f"Total time: {time.time() - t0:.6f} seconds")
    if args.profile:
        print(event_log.report())
    return u


if __name__ == "__main__":
    main()
