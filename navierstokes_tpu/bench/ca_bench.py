"""CA-GMRES vs standard GMRES on the chip at 121k DoF.

Answers whether the communication-avoiding s-step machinery (the intent of
the reference's `src/sstepgmres.c:126-149`) pays on ONE chip, where there is
no inter-device latency to avoid — the win, if any, must come from batching
the basis construction (fewer kernel dispatches, projections as matmuls).

Times the REAL solver path (`_solve_prepared`) with method gmres vs
ca_gmres on the prepared exact-Jacobian operator two ways:
- fixed iteration counts (32/64) via rtol=atol=0, with `chained_op_time`
  (per-iteration slope, immune to dispatch pipelining), and
- a tolerance-targeted solve of a fixed RHS: wall time + converged iters
  (convergence-quality comparison — s-step bases lose orthogonality faster).

Usage: python -m navierstokes_tpu.bench.ca_bench [--matrix-id 6]
"""
import argparse
import dataclasses
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, default=6)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.bench.timing import chained_op_time
    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.model.navier_stokes import _merge_prep, _split_prep

    krylov = SolverConfig(rtol=1e-5, atol=1e-6, maxiter=1000,
                          neumann_order=0, preconditioner="two_level",
                          coarse_agg=48)
    cfg = NSConfig(
        dt=1e-3, reynolds=300.0, delta=0.05, dtype="float32",
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=krylov, stokes_krylov=krylov,
    )
    mesh = scaling_series_mesh(args.matrix_id)
    solver = NavierStokesSolver(mesh, cfg)
    n = solver.disc.ndof
    log(f"ndof={n}")
    static, arrays = _split_prep(solver._exact_prep)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    def fixed(method, iters):
        kv = dataclasses.replace(krylov, method=method, rtol=0.0, atol=0.0,
                                 maxiter=iters)

        def g(v, arrs):
            pp = _merge_prep(static, arrs)
            return solver._solve_prepared(pp, v, kv).x

        return g

    for method in ("gmres", "ca_gmres"):
        t32 = chained_op_time(fixed(method, 32), b, operands=(arrays,))
        t64 = chained_op_time(fixed(method, 64), b, operands=(arrays,))
        per = (t64 - t32) / 32
        log(f"{method:9s} 32 iters {t32 * 1e3:8.2f} ms  64 iters "
            f"{t64 * 1e3:8.2f} ms  per-iter {per * 1e6:7.1f} us")

    # Tolerance-targeted solve of a fixed synthetic RHS.  For ca_gmres the
    # basis length (= min(restart, 16)) governs the basis conditioning, so
    # sweep it, for BOTH polynomial bases: monomial (stalls in f32 — every
    # length 6-16, round-3 measurement) and the Leja-shifted Newton basis
    # (solvers.sstep.newton_shifts — the textbook conditioning fix).
    configs = [("gmres", 30, "monomial")] + [
        ("ca_gmres", m, basis)
        for basis in ("monomial", "newton") for m in (16, 12, 8, 6)
    ]
    for method, restart, basis in configs:
        kv = dataclasses.replace(krylov, method=method, restart=restart,
                                 ca_basis=basis)
        if method == "ca_gmres" and basis == "newton":
            # shifts for THIS basis length (kv.ca_basis routes them in
            # _solve_prepared_raw)
            solver._ca_shifts = solver._build_ca_shifts(
                solver._exact_prep, min(restart, 16))

        @jax.jit
        def solve(v, arrs, kv=kv):
            pp = _merge_prep(static, arrs)
            r = solver._solve_prepared(pp, v, kv)
            return r.x, r.iters, r.resnorm, r.converged

        x, it, rn, conv = solve(b, arrays)
        x.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(5):
            x, it, rn, conv = solve(b, arrays)
        x.block_until_ready()
        dt = (time.perf_counter() - t0) / 5
        tag = f"{method}[m={min(restart, 16) if method == 'ca_gmres' else restart}"
        tag += f",{basis[:4]}]" if method == "ca_gmres" else "]"
        log(f"{tag:19s} to tol: {dt * 1e3:8.2f} ms  iters={int(it)} "
            f"resnorm={float(rn):.3e} converged={bool(conv)}")


if __name__ == "__main__":
    main()
