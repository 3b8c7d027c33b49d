"""Per-iteration decomposition of the preconditioned GMRES on the device.

Times the REAL solver components
(via `model._prep_operators` — not re-implementations) with
`chained_op_time`, plus the GMRES-internal costs (CGS2 against the
(m+1, n) basis, the in-place V row update) and the end-to-end
per-iteration slope of `_solve_prepared` at fixed 32/64 iterations.

The reference analog is the `-log_view` stage breakdown
(`/root/reference/src/solve_newton.c:1290-1310`) that attributes KSP time
to MatMult/PCApply/VecMDot.

Usage:
    python -m navierstokes_tpu.bench.gmres_decomp --matrix-id 10 \
        [--coarse-agg 256] [--disc-cache DIR] [--skip-slope]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def log(*args):
    print(*args, flush=True)


# Per-size coarse defaults (config.auto_coarse_agg).
_COARSE_DEFAULTS = {6: dict(coarse_agg=48), 8: dict(coarse_agg=128),
                    10: dict(coarse_agg=256)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, default=6)
    p.add_argument("--coarse-agg", type=int, default=None)
    p.add_argument("--restart", type=int, default=30)
    p.add_argument("--spmv", default=None,
                   help="override SolverConfig.spmv (e.g. plane)")
    p.add_argument("--disc-cache", default=None)
    p.add_argument("--skip-slope", action="store_true",
                   help="components only (each slope pair is 2 more big "
                        "compiles)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from navierstokes_tpu.bench.timing import chained_op_time
    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.model.navier_stokes import _merge_prep, _split_prep

    agg = args.coarse_agg or \
        _COARSE_DEFAULTS.get(args.matrix_id, {}).get("coarse_agg", 48)
    krylov = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                          neumann_order=0, preconditioner="two_level",
                          coarse_agg=agg, coarse_dense_max=16384,
                          restart=args.restart,
                          **({"spmv": args.spmv} if args.spmv
                             else {}))
    cfg = NSConfig(
        dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov,
    )

    disc = mesh = None
    if args.disc_cache:
        import os

        from navierstokes_tpu.fem.assembly import (
            build_discretization,
            load_discretization,
            save_discretization,
        )

        if os.path.exists(f"{args.disc_cache}/mesh.pkl"):
            t0 = time.perf_counter()
            disc = load_discretization(args.disc_cache, dtype=jnp.float32)
            mesh = disc.mesh
            log(f"disc cache loaded {time.perf_counter() - t0:.1f} s")
        else:
            mesh = scaling_series_mesh(args.matrix_id)
            disc = build_discretization(mesh, dtype=jnp.float32)
            save_discretization(disc, args.disc_cache)
    if mesh is None:
        mesh = scaling_series_mesh(args.matrix_id)

    t0 = time.perf_counter()
    solver = NavierStokesSolver(mesh, cfg, disc=disc)
    solver._ensure_prepared()
    solver.release_assembly_buffers()
    n = solver.disc.ndof
    cs = solver._coarse_space
    log(f"ndof={n} coarse_agg={agg} nc={cs.nc} "
        f"prep {time.perf_counter() - t0:.1f} s")
    static, arrays = _split_prep(solver._exact_prep)
    rng = np.random.default_rng(0)
    # Plane-mode preps ('tlp') iterate on plane-major vectors of length
    # 4*nbp; the component closures take that layout directly.
    n_vec = 4 * static[4] if static[0] == "tlp" else n
    b = jnp.asarray(rng.standard_normal(n_vec), jnp.float32)
    m = args.restart

    def part_fn(name):
        def g(v, arrs):
            return solver._prep_operators(_merge_prep(static, arrs))[2][name](v)
        return g

    def matvec_fn(v, arrs):
        return solver._prep_operators(_merge_prep(static, arrs))[0](v)

    rows = []

    def timed(label, fn, x0, operands=(arrays,)):
        t = chained_op_time(fn, x0, operands=operands)
        rows.append((label, t))
        log(f"  {label:42s} {t * 1e6:9.1f} us")

    log("components (chained/slope, real solver closures):")
    timed("spmv_A", part_fn("apply_A"), b)
    timed("apply_Dinv", part_fn("apply_Dinv"), b)
    timed("coarse P Ac^-1 R", part_fn("coarse"), b)
    timed("minv (two-level apply)", part_fn("minv"), b)
    timed("matvec = minv(A x)", matvec_fn, b)

    # GMRES internals at half-full basis (k = m//2): CGS2's four GEMVs read
    # the whole (m+1, n) buffer regardless of k (rows > k are zero-masked).
    from navierstokes_tpu.solvers.gmres import cgs2_project

    V = jnp.asarray(rng.standard_normal((m + 1, n_vec)), jnp.float32)
    k = m // 2

    def cgs2(w, Vb):
        return cgs2_project(Vb, w, k)[0]

    timed(f"CGS2 vs ({m + 1},n) basis (k={k})", cgs2, b, operands=(V,))

    cgs2_key = f"CGS2 vs ({m + 1},n) basis (k={k})"
    del V

    comp = dict(rows)
    est = (comp["matvec = minv(A x)"] + comp[cgs2_key])
    log(f"  matvec + CGS2 estimate per iteration: {est * 1e6:9.1f} us")

    if args.skip_slope:
        return

    b0 = jnp.asarray(rng.standard_normal(n), jnp.float32)

    def timed_solve(iters, reps=5):
        # Direct wall timing with manual data-chaining (each solve's RHS is
        # the previous normalized solution, so calls cannot overlap);
        # whole multi-ms solves are too large to chain 64-deep inside
        # chained_op_time's fori_loop at 2.35M rows.
        kv = dataclasses.replace(krylov, rtol=0.0, atol=0.0, maxiter=iters)

        @jax.jit
        def s(v, arrs):
            x = solver._solve_prepared(_merge_prep(static, arrs), v, kv).x
            return x / jnp.maximum(jnp.max(jnp.abs(x)), 1e-30)

        v = s(b0, arrays)
        v.block_until_ready()               # compile + warmup
        t0 = time.perf_counter()
        for _ in range(reps):
            v = s(v, arrays)
        v.block_until_ready()
        return (time.perf_counter() - t0) / reps

    log("end-to-end (real _solve_prepared, fixed iteration counts):")
    t32 = timed_solve(32)
    log(f"  gmres 32 fixed iters {t32 * 1e3:10.2f} ms")
    t64 = timed_solve(64)
    log(f"  gmres 64 fixed iters {t64 * 1e3:10.2f} ms")
    per = (t64 - t32) / 32
    log(f"  per-iteration (slope 32->64) {per * 1e6:9.1f} us "
        f"(matvec+CGS2 predict {est * 1e6:.1f}; the gap is the V update, "
        f"Givens scan and norms)")


if __name__ == "__main__":
    main()
