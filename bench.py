"""Benchmark: block-sparse SpMV on the mmesh-class NS operator.

Reproduces the reference's headline benchmark (`mpk/log/log_SPMV.txt`,
`src/benchmark_spmv.c`): y = A x on the 121k-row Navier–Stokes BAIJ-4x4
operator, GFLOP/s = 2*nnz/t (the reference's own formula,
`src/benchmark_spmv.c:234`).  Baseline to beat: 3.85 GFLOP/s (3.457 ms) for
the hand-written AVX2 BCSR4 kernel on one x86 core (BASELINE.md).

Timing methodology: iterations are chained data-dependently (the output,
cheaply normalized, feeds the next input) inside ONE jitted fori_loop with a
traced trip count, and the per-op time is the slope between two trip counts —
this defeats both dispatch pipelining and the fixed sync latency.

Prints ONE JSON line naming the device it ran on; extra detail goes to
stderr.
"""

import argparse
import json
import sys
import time

import numpy as np

BASELINE_GFLOPS = 3.85  # BCSR4 AVX2, matrix 6 (121,480 rows), BASELINE.md

SMOKE = False  # --smoke: tiny mesh, minimal chains — path check, not a timing


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def fit_time(step_fn, x0, operands=(), r1=64, r2=256):
    """Per-iteration time of a data-dependent chain, overhead-corrected.
    Operator data flows through `operands` (jit args, not closure constants)."""
    from navierstokes_tpu.bench.timing import chained_op_time

    if SMOKE:  # shortest valid slope pair; numbers are not meaningful
        t = chained_op_time(step_fn, x0, operands=operands, r1=2,
                            best_of=1, min_delta=-1.0)
        return max(t, 1e-9)  # noise can make the 6-op slope <= 0 on CPU
    return chained_op_time(step_fn, x0, operands=operands, r1=r1)


def main():
    global SMOKE
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="tiny mesh + minimal timing chains: exercises every "
                        "benchmarked code path end-to-end (the JSON contract "
                        "check tests/test_driver_artifacts.py runs on CPU); "
                        "timings are meaningless in this mode")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (path check only)")
    args = p.parse_args()
    SMOKE = args.smoke

    import jax

    from navierstokes_tpu.utils.compile_cache import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()

    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        LINEAR_TERMS,
        assemble_operator,
        build_discretization,
    )
    from navierstokes_tpu.mesh.box import channel_mesh
    from navierstokes_tpu.ops.spmv import spmv_bell, spmv_dia
    from navierstokes_tpu.sparse.bell import bell_from_bcsr
    from navierstokes_tpu.sparse.dia import dia_values_from_bcsr_values

    dtype = jnp.float32
    log(f"backend={jax.default_backend()} devices={jax.devices()}")

    # mmesh-class: ~30k nodes -> ~121k rows (reference matrix 6: 30,370 nodes)
    if SMOKE:
        mesh = channel_mesh(8, 4, 4, length=4.0, obstacle=True)
    else:
        mesh = channel_mesh(46, 24, 24, length=4.0, obstacle=True)
    log(f"mesh: {mesh.nv} nodes ({4 * mesh.nv} rows), {mesh.ne} tets")

    from navierstokes_tpu.fem.assembly import assemble_dia_values

    disc = build_discretization(mesh, dtype=dtype)
    pat = disc.dia_pattern
    nnz = pat.nnz
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(disc.ndof), dtype=dtype
    )

    # Headline: scalar-DIA fast path (the layout the solver actually uses),
    # assembled directly into the flat layout (scalable path).
    dummy_UL = jnp.zeros((disc.ne, 3, 4), dtype=dtype)
    dia_data = assemble_dia_values(
        disc.tets, disc.vol, disc.grad, disc.h, dummy_UL, 0.001, 300.0, 0.05,
        disc.dia_elem_map, terms=LINEAR_TERMS, K=pat.K, ndof=disc.ndof,
    )
    offsets = pat.offsets

    # Memory footprint per variant (the `src/benchmark_spmv.c:167-207`
    # analog) — the SpMV is a memory-bound stream, so the bytes each layout
    # streams per SpMV matter as much as the time.
    raw = nnz * jnp.dtype(dtype).itemsize
    log(f"operator footprint: raw nnz       {raw / 1e6:8.1f} MB")
    log(f"operator footprint: DIA (K={pat.K:3d})  "
        f"{dia_data.nbytes / 1e6:8.1f} MB ({dia_data.nbytes / raw:.2f}x "
        "inflation)")
    t_dia = fit_time(lambda v, data: spmv_dia(offsets, data, v), x,
                     operands=(dia_data,))
    log(f"spmv DIA (XLA) f32: {t_dia * 1e6:8.1f} us -> "
        f"{2.0 * nnz / t_dia / 1e9:7.1f} GFLOP/s (K={pat.K} diagonals)")

    # Component-plane layout (the solver flagship's operator): 0.74x the
    # scalar-DIA bytes (bench/layout_census.py), timed in its native layout
    # exactly as the solver runs it (spmv='plane' keeps the whole Krylov
    # space plane-major; conversions happen only at step boundaries).
    from navierstokes_tpu.ops.plane_dia import (
        extract_planes,
        node_offsets_from_scalar,
        spmv_planes,
        to_planes,
    )

    noffs = node_offsets_from_scalar(offsets)
    nb = disc.ndof // 4
    p4 = extract_planes(offsets, dia_data, nb, node_offsets=noffs)
    p4.block_until_ready()
    xp = to_planes(x, nb, nb)
    t_pl = fit_time(lambda v, d4: spmv_planes(noffs, d4, v), xp,
                    operands=(p4,))
    log(f"spmv plane-major (N_D={len(noffs)}): "
        f"{t_pl * 1e6:8.1f} us -> {2.0 * nnz / t_pl / 1e9:7.1f} GFLOP/s")
    t_best = min(t_dia, t_pl)
    del p4, xp
    gflops = 2.0 * nnz / t_best / 1e9

    # Secondary: block-ELL gather path (for the record)
    op = assemble_operator(
        disc, jnp.zeros(disc.ndof, dtype), 0.001, 300.0, 0.05, LINEAR_TERMS
    )
    ell = bell_from_bcsr(op)
    idx = jnp.asarray(ell.indices)
    ell_bytes = ell.values.nbytes + idx.nbytes
    log(f"operator footprint: block-ELL    {ell_bytes / 1e6:8.1f} MB "
        f"({ell_bytes / raw:.2f}x)")
    t_ell = fit_time(lambda v, vals: spmv_bell(idx, vals, v), x,
                     operands=(ell.values,))
    log(f"spmv ELL f32:  {t_ell * 1e6:8.1f} us -> {2 * nnz / t_ell / 1e9:7.1f} GFLOP/s")

    log(f"vs reference AVX2 3.457 ms: {3.457e-3 / t_best:.0f}x faster")

    # Solver-level numbers: per-step time of the flagship transient at the
    # same 121k DoF (run.py f32 defaults, exact Jacobian, operator
    # residual).  Tracks the PRODUCT, not just the kernel, so a regression
    # in iterations/preconditioning shows up in the JSON line.
    del dia_data, op, ell, idx
    step_ms, newton_iters, lin_iters = bench_solver_step(
        mesh, n_steps=2 if SMOKE else 10
    )

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "spmv_gflops_121k_ns_matrix",
        "value": round(gflops, 2),
        "unit": "GFLOP/s",
        "vs_baseline": round(gflops / BASELINE_GFLOPS, 2),
        "step_ms_121k": round(step_ms, 1),
        "newton_iters": newton_iters,
        "lin_iters": lin_iters,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


def bench_solver_step(mesh, n_steps: int = 10):
    """Mean per-step wall time of the jitted Newton step at 121k DoF.

    Steps are naturally chained (u feeds the next step), so dispatching
    n_steps and blocking once amortizes the sync latency.
    """
    import time

    import jax.numpy as jnp

    from navierstokes_tpu.config import NewtonConfig, NSConfig
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.run import default_f32_krylov

    # Flagship config (run.py f32 defaults, single source of truth):
    # component-plane layout + the auto schedules — at this size
    # preconditioner="auto" resolves to two_level with a degree-3 Chebyshev
    # post-smoother.
    krylov = default_f32_krylov()
    cfg = NSConfig(
        dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov,
    )
    solver = NavierStokesSolver(mesh, cfg)
    u = solver.stokes_init()
    u.block_until_ready()
    u_old, du = u, jnp.zeros_like(u)
    # warmup: compile the step
    u1, du1, stats = solver.step(u, u_old, du)
    u1.block_until_ready()
    t0 = time.perf_counter()
    # u_old advances to the CURRENT solution each step (as model.run()
    # does); passing the two-steps-back state re-solves a converged
    # interval on alternating calls and halves apparent step cost.
    u_cur, du_cur = u1, du1
    for _ in range(n_steps):
        u_cur, du_cur, stats = solver.step(u_cur, u_cur, du_cur)
    u_cur.block_until_ready()
    dt_step = (time.perf_counter() - t0) / n_steps
    rk = solver.cfg.krylov
    log(f"transient step (121k, {rk.preconditioner} agg={rk.coarse_agg} "
        f"cheby={rk.coarse_cheby}): {dt_step * 1e3:8.1f} ms "
        f"newton={int(stats.iters)} lin={int(stats.lin_iters)}")
    return dt_step * 1e3, int(stats.iters), int(stats.lin_iters)


if __name__ == "__main__":
    main()
