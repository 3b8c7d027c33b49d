"""Restarted GMRES(m) as a jitted `lax.while_loop` — the KSPGMRES equivalent.

Semantics match the reference's solver configuration
(`src/solve_newton.c:1154-1163`): left preconditioning, CGS2 (twice-iterated
classical Gram–Schmidt) Arnoldi — numerically as robust as the reference's
modified Gram–Schmidt but expressed as four fused GEMVs instead of a
sequential dot/axpy chain — Givens-rotation least squares (vectorized via an
associative scan over the rotation recurrence), convergence when the preconditioned
residual norm drops below max(rtol * ||r0||_pre, atol) (PETSc
`KSPConvergedDefault`), restart length m, total-iteration cap.

Everything is static-shaped: the Krylov basis is a fixed (m+1, n) buffer and
the Hessenberg/Givens state fixed (m+1, m) — no recompilation across calls.
"""

from __future__ import annotations


from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class GMRESResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray         # total inner iterations performed
    resnorm: jnp.ndarray       # final preconditioned residual norm
    converged: jnp.ndarray     # bool


def _identity(x):
    return x


def cgs2_project(V, w, k):
    """CGS2 (classical Gram-Schmidt, twice) of w against rows 0..k of V.

    V is the (m+1, n) Krylov basis buffer; rows beyond k are masked out of
    both passes, so h[k+1:] is exactly zero.  Each pass is two GEMVs over
    the whole buffer instead of a sequential chain of k dots/axpys.
    precision=HIGHEST: a reduced default matmul precision (TF32 on the
    GPU) would orthogonalize against a truncated basis.  Returns
    (w - V^T h, h)."""
    hp = jax.lax.Precision.HIGHEST
    active = (jnp.arange(V.shape[0]) <= k).astype(w.dtype)
    h1 = jnp.matmul(V, w, precision=hp) * active
    w = w - jnp.matmul(V.T, h1, precision=hp)
    h2 = jnp.matmul(V, w, precision=hp) * active
    w = w - jnp.matmul(V.T, h2, precision=hp)
    return w, h1 + h2


def gmres(
    matvec: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    precond: Optional[Callable] = None,
    restart: int = 30,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 2000,
) -> GMRESResult:
    """NOTE: deliberately not jitted here — `matvec`/`precond` typically close
    over traced operator values, so callers jit the enclosing step function
    (e.g. the whole Newton iteration) and this trace inlines into it."""
    n = b.shape[0]
    dtype = b.dtype
    m = restart
    M = precond or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def pre_residual(x):
        return M(b - matvec(x))

    r0 = pre_residual(x0)
    beta0 = jnp.linalg.norm(r0)
    tol = jnp.maximum(rtol * beta0, atol)

    # Outer state: (x, total_iters, resnorm, converged, stalled)
    def outer_cond(state):
        _, iters, resnorm, converged, stalled = state
        return (~converged) & (~stalled) & (iters < maxiter) & (resnorm > 0.0)

    def outer_body(state):
        x, iters, prev_resnorm, _, _ = state
        r = pre_residual(x)
        beta = jnp.linalg.norm(r)

        v0 = r / jnp.where(beta > 0, beta, 1.0)
        V = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(v0)
        R = jnp.zeros((m, m), dtype=dtype)         # triangularized Hessenberg
        cs = jnp.zeros(m, dtype=dtype)
        sn = jnp.zeros(m, dtype=dtype)
        g = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)

        # Inner state: (V, R, cs, sn, g, k, done, brk)
        def inner_cond(istate):
            _, _, _, _, _, k, done, _ = istate
            return (k < m) & (~done)

        def inner_body(istate):
            V, R, cs, sn, g, k, _, _ = istate
            w = M(matvec(V[k]))
            # NOTE on active-row skipping: CGS2's four GEMVs read the whole
            # zero-padded (m+1, n) buffer every iteration even though only
            # k+1 rows are live.  Skipping the dead rows with lax.cond puts
            # a fusion boundary per branch in the loop; a GEMV with a
            # dynamic row bound is the remaining option if CGS2 ever
            # dominates.
            w, h = cgs2_project(V, w, k)
            hk1 = jnp.linalg.norm(w)
            # One dynamic-update-slice on the loop-carried buffer; written
            # unconditionally (on breakdown the row is never read: k does
            # not advance, y is zero past k_end, and the next restart
            # rebuilds V) so XLA updates V in place — a conditional
            # jnp.where(keep, V_next, V) would force a full (m+1, n) copy
            # plus a 3-buffer select every iteration.
            vnew = w / jnp.where(hk1 > 0, hk1, 1.0)
            V = V.at[k + 1].set(vnew)

            # Apply accumulated rotations 0..k-1 to the new column h[0..k].
            # The pairwise updates form the first-order linear recurrence
            #   c_{i+1} = -sn_i c_i + cs_i h_{i+1},  c_0 = h_0
            # (c_i = value at position i when rotation i arrives), solved in
            # O(log m) vector steps by associative_scan instead of an m-trip
            # sequential fori_loop of dynamic scalar updates.
            idx = jnp.arange(m)
            lt = idx < k
            a = jnp.where(lt, -sn, 1.0)
            b = jnp.where(lt, cs * h[1:], 0.0)

            def compose(first, second):
                a1, b1 = first
                a2, b2 = second
                return a2 * a1, a2 * b1 + b2

            P, Q = jax.lax.associative_scan(compose, (a, b))
            c = jnp.concatenate([h[:1], P * h[0] + Q])          # (m+1,)
            # Rotated column: positions < k rotated, k carries c_k, > k keep
            # h (zero there — the active mask zeroed rows beyond k).
            col = jnp.where(
                lt, cs * c[:m] + sn * h[1:],
                jnp.where(idx == k, c[:m], h[:m]),
            )

            # New Givens zeroing the subdiagonal entry hk1.
            a_ = c[k]
            denom = jnp.sqrt(a_ * a_ + hk1 * hk1)
            # Hard breakdown: the prospective R[k,k] is numerically zero
            # RELATIVE to the new Hessenberg column (rotations are
            # orthogonal, so ||(h, hk1)|| is the rotation-invariant column
            # scale).  This is the numerically-singular-H case (invariant
            # Krylov subspace that does not contain b, e.g. a singular
            # operator): the rotation built from the O(eps) remainder would
            # report a ~0 least-squares residual while R is singular and x
            # garbage.  An absolute 1e-300 test provably misses it — a
            # rank-1 64x64 system measured denom=1.4e-17 against colnorm=1
            # and "converged" at resnorm 2.8e-14 with true residual 63.5.
            # State is written anyway (those slots are never read once k
            # stops advancing) but k must NOT advance.
            colnorm = jnp.sqrt(jnp.sum(h * h) + hk1 * hk1)
            eps4 = jnp.asarray(4.0, dtype) * jnp.finfo(dtype).eps
            breakdown = denom <= colnorm * eps4
            c_new = jnp.where(breakdown, 1.0, a_ / denom)
            s_new = jnp.where(breakdown, 0.0, hk1 / denom)
            cs = cs.at[k].set(c_new)
            sn = sn.at[k].set(s_new)
            R = R.at[:, k].set(col.at[k].set(denom))

            gk = g[k]
            g = g.at[k].set(c_new * gk).at[k + 1].set(-s_new * gk)
            res_est = jnp.abs(g[k + 1])
            # Happy breakdown (hk1 == 0 but column useful) still advances once.
            done = (res_est <= tol) | (hk1 <= 1e-300) | breakdown
            return (V, R, cs, sn, g, jnp.where(breakdown, k, k + 1), done,
                    breakdown)

        V, R, cs, sn, g, k_end, _, brk = jax.lax.while_loop(
            inner_cond,
            inner_body,
            (V, R, cs, sn, g, jnp.int32(0), beta <= tol,
             jnp.asarray(False)),
        )

        # Solve R[0:k_end, 0:k_end] y = g[0:k_end] on the padded system:
        # pad unused diagonal with 1 and unused rhs with 0.
        col_ids = jnp.arange(m)
        active = col_ids < k_end
        Rp = jnp.where(
            active[None, :] & active[:, None],
            R,
            jnp.eye(m, dtype=dtype),
        )
        gp = jnp.where(active, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rp, gp, lower=False)
        dx = jnp.matmul(V[:m].T, y, precision=jax.lax.Precision.HIGHEST)
        x_new = x + dx

        resnorm = jnp.abs(g[k_end])
        # Stalled: the cycle made no progress at all (immediate breakdown),
        # or it hit a hard breakdown AND shrank the residual by <1% — the
        # invariant-subspace case recurs identically every restart, so
        # cycling to maxiter would only burn matvecs.  A breakdown cycle
        # that still made progress restarts normally (preconditioned solves
        # can recover from an isolated rank deficiency).
        stalled = (k_end == 0) | (
            brk & (resnorm >= 0.99 * prev_resnorm)
        )
        return (
            x_new,
            iters + k_end,
            resnorm,
            resnorm <= tol,
            stalled,
        )

    init = (x0, jnp.int32(0), beta0, beta0 <= tol, jnp.asarray(False))
    x, iters, resnorm, converged, _ = jax.lax.while_loop(
        outer_cond, outer_body, init
    )
    return GMRESResult(x=x, iters=iters, resnorm=resnorm, converged=converged)
