"""Timing utilities for device benchmarks.

Two defenses against misleading numbers on an asynchronous device:
  1. iterations are chained data-dependently (output, cheaply normalized,
     feeds the next input) inside one jitted fori_loop so the runtime cannot
     overlap them — the analog of the reference's `flush_cache` discipline
     (`mpk/utils.cpp:146-154`), which exists for the same reason: defeating
     an optimization (cache reuse there, dispatch pipelining here) that
     benchmarks the machinery instead of the kernel;
  2. per-op time is the SLOPE between two traced trip counts, subtracting
     the fixed dispatch/sync latency.

Best-of-N repeats mirror `src/main.c:127-137`.
"""

from __future__ import annotations

import time


def chained_op_time(step_fn, x0, operands=(), r1=64, best_of=3, min_delta=0.05):
    """Per-iteration seconds of `step_fn(v, *operands)`, overhead-corrected.

    The trip-count pair adapts upward until the extra work dominates the
    fixed sync latency (otherwise tiny kernels drown in measurement noise).

    Pass large arrays (operator data, ...) via `operands`, NOT via closure:
    jit-closure arrays are embedded as literal constants in the executable,
    which bloats compile time and every cache entry.
    """
    import jax
    import jax.numpy as jnp

    def chain_fn(v, n, *ops):
        def body(_, u):
            y = step_fn(u, *ops)
            return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-30)

        return jax.lax.fori_loop(0, n, body, v)

    chain = jax.jit(chain_fn)
    float(jnp.sum(chain(x0, 4, *operands)))  # compile + warmup

    def measure(n):
        best = float("inf")
        for _ in range(best_of):
            t0 = time.perf_counter()
            float(jnp.sum(chain(x0, n, *operands)))
            best = min(best, time.perf_counter() - t0)
        return best

    r2 = 4 * r1
    t1, t2 = measure(r1), measure(r2)
    while t2 - t1 < min_delta and r2 < 600_000:
        r1, t1 = r2, t2
        r2 = 4 * r2
        t2 = measure(r2)
    return (t2 - t1) / (r2 - r1)


def rel_error(y, y_ref):
    """Relative L2 error — `rel_error` (`mpk/utils.cpp:131-143`)."""
    import numpy as np

    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref, np.float64)
    denom = np.linalg.norm(y_ref)
    return float(np.linalg.norm(y - y_ref) / denom) if denom else float("nan")
