"""s-step (communication-avoiding) GMRES built on the matrix-powers kernel.

The completed form of the reference's `sstepgmres.c` scaffold (SURVEY.md §2.1
#19 — a KSPSHELL whose solve callback was a placeholder, intended to sit on
`BuildKrylovBasis_AVX2` + `MatMatMult_SeqBAIJ_4_AVX2`).

Algorithm per restart cycle (Walker/Hoemmen-style, monomial basis):
  1. r0 = M^{-1}(b - A x),  V = [r0, (M^{-1}A) r0, ..., (M^{-1}A)^m r0]
     with per-column normalization recorded in the recurrence matrix S:
     (M^{-1}A) V[:, i] = alpha_i V[:, i+1]  =>  S[i+1, i] = alpha_i.
     On a device mesh this is ONE communication phase (the k-deep-halo
     `partitioned_spmv_power`); on a single chip it is one fused dispatch.
  2. Tall-skinny QR: V = Q R.
  3. Arnoldi projection without inner products against A:
     H = R S R_m^{-1}  (exact algebraic identity,  H (m+1, m)).
  4. Least squares min ||R[:, 0] - H y||  (r0 = V e1 = Q R[:, 0]).
  5. x += Q_m y;  restart until converged.

Tradeoff vs standard GMRES: the monomial basis conditions like kappa(A)^m,
so the usable basis length m is smaller (~8-16 with normalization); in
exchange, the dots/AXPYs of modified Gram-Schmidt collapse into one QR and
the s SpMVs into one matrix-powers sweep — the communication-avoiding axis
the reference explores (BASELINE.md "SpM2V / 2SpMV" configs).

NEWTON BASIS (`shifts`): the monomial stall in f32 (measured at 117k rows:
every basis length 6-16 stalls short of tolerance)
is the textbook basis-conditioning failure, and the textbook fix (Bai/Hu/
Reichel; Hoemmen's thesis ch. 7) is the shifted product basis

    v_{i+1} = ((M^{-1}A) - theta_i I) v_i / alpha_i,

with theta_i the Ritz values of the preconditioned operator in LEJA order
(greedily maximizing pairwise distance products, so partial products stay
well scaled).  The recurrence matrix gains a diagonal: S[i, i] = theta_i,
S[i+1, i] = alpha_i; everything else (QR, H = R S R_m^{-1}, small least
squares) is unchanged.  Shifts are computed ONCE at operator-preparation
time from a short Arnoldi sweep (`newton_shifts`, host eig + Leja order);
complex Ritz pairs are reduced to their real parts to keep the recurrence
(and the one-exchange matrix-powers kernel) in real arithmetic — a
conditioning compromise vs the full conjugate-pair recurrence.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from navierstokes_tpu.solvers.gmres import GMRESResult


def _identity(x):
    return x


def leja_order(vals):
    """Greedy Leja ordering of a point set (host, numpy).

    out[0] = argmax |v|; out[k] maximizes sum_j log|v - out[j]| over the
    remaining points (log sums instead of products: the raw products over/
    underflow for >~30 points).  Duplicate points get -inf scores once
    their twin is chosen and land last — harmless (equal shifts repeat)."""
    import numpy as np

    v = np.asarray(vals)
    n = v.shape[0]
    if n == 0:
        return v
    chosen = [int(np.argmax(np.abs(v)))]
    rest = [i for i in range(n) if i != chosen[0]]
    # running sum of log-distances to the chosen set, updated incrementally
    with np.errstate(divide="ignore"):
        score = np.log(np.abs(v - v[chosen[0]]))
    while rest:
        j = max(rest, key=lambda i: score[i])
        chosen.append(j)
        rest.remove(j)
        with np.errstate(divide="ignore"):
            score = score + np.log(np.abs(v - v[j]))
    return v[chosen]


def newton_shifts(H, s: int):
    """Leja-ordered real Newton-basis shifts from an Arnoldi Hessenberg H.

    Takes the square part of an (m+1, m) (or (m, m)) Hessenberg from a
    prepare-time Arnoldi sweep on the preconditioned operator, computes its
    Ritz values in f64 on the host, drops to real parts (real-arithmetic
    recurrence — see module docstring), Leja-orders, and returns `s` shifts
    (cycled if s > m)."""
    import numpy as np

    h = np.asarray(H, dtype=np.float64)
    m = min(h.shape)
    theta = np.linalg.eigvals(h[:m, :m])
    ordered = leja_order(np.real(theta))
    reps = -(-s // ordered.shape[0])
    return tuple(float(t) for t in np.tile(ordered, reps)[:s])


def ca_gmres(
    matvec: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    precond: Optional[Callable] = None,
    basis: int = 12,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 2000,
    powers_fn: Optional[Callable] = None,
    shifts: Optional[tuple] = None,
) -> GMRESResult:
    """Restarted s-step GMRES with basis length `basis` (= s = m per cycle).

    `powers_fn(v, s) -> (n, s)` optionally supplies the raw power stack
    [A v, ..., A^s v] in one call — on a device mesh this is the one-deep-
    halo-exchange `partitioned_spmv_dia_power(..., return_all=True)`, making
    the whole cycle's SpMV communication a single exchange.  Normalized
    columns and recurrence coefficients are reconstructed from the raw
    column norms (v_{i+1} = raw_{i+1}/|raw_{i+1}|, alpha_i =
    |raw_{i+1}|/|raw_i|).  Only valid with precond=None (fold the
    preconditioner into the operator first — see model._prepare_operator).

    `shifts` (tuple of m floats, from `newton_shifts`) switches the basis
    from monomial to the Leja-ordered Newton basis (module docstring).
    With powers_fn, the powers function must accept (v, s, shifts) and
    apply them between sweeps (`parallel.partitioned_spmv_*_power` do).

    Same call/convergence semantics as `solvers.gmres.gmres`; not jitted here
    for the same closure reasons.
    """
    if powers_fn is not None and precond is not None:
        raise ValueError("powers_fn requires the preconditioner folded into A")
    n = b.shape[0]
    dtype = b.dtype
    m = basis
    if shifts is not None:
        if len(shifts) < m:
            raise ValueError(f"need >= basis={m} shifts, got {len(shifts)}")
        shifts = tuple(shifts[:m])
    M = precond or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0

    def pre_residual(x):
        return M(b - matvec(x))

    beta0 = jnp.linalg.norm(pre_residual(x0))
    tol = jnp.maximum(rtol * beta0, atol)
    eps_floor = jnp.asarray(1e-300, dtype)

    def cycle(x):
        r = pre_residual(x)

        # 1. Normalized monomial basis + recurrence coefficients.
        v0norm = jnp.linalg.norm(r)
        v0 = r / jnp.maximum(v0norm, eps_floor)
        if powers_fn is not None:
            raw = (powers_fn(v0, m) if shifts is None
                   else powers_fn(v0, m, shifts))              # (n, m)
            norms = jnp.linalg.norm(raw, axis=0)               # (m,)
            safe = jnp.maximum(norms, eps_floor)
            Vs = raw / safe[None, :]
            prev = jnp.concatenate([jnp.ones((1,), dtype), norms[:-1]])
            alphas = norms / jnp.maximum(prev, eps_floor)
            V = jnp.concatenate([v0[:, None], Vs], axis=1)     # (n, m+1)
        else:
            th = jnp.zeros((m,), dtype) if shifts is None else \
                jnp.asarray(shifts, dtype)

            def step(carry, theta):
                v = carry
                w = M(matvec(v)) - theta * v
                alpha = jnp.linalg.norm(w)
                v_next = w / jnp.maximum(alpha, eps_floor)
                return v_next, (v_next, alpha)

            _, (vs, alphas) = jax.lax.scan(step, v0, th)
            V = jnp.concatenate([v0[None], vs], axis=0).T      # (n, m+1)

        # 2. Tall-skinny QR.
        Q, R = jnp.linalg.qr(V)                                # (n,m+1),(m+1,m+1)

        # 3. H = R S R_m^{-1}; S[i+1, i] = alphas[i] (+ S[i, i] = theta_i
        #    for the Newton basis: (M^-1 A) v_i = theta_i v_i + alpha_i
        #    v_{i+1}).
        S = jnp.zeros((m + 1, m), dtype=dtype)
        S = S.at[jnp.arange(1, m + 1), jnp.arange(m)].set(alphas)
        if shifts is not None:
            S = S.at[jnp.arange(m), jnp.arange(m)].set(
                jnp.asarray(shifts, dtype))
        # HIGHEST: reduced-precision (TF32) operand rounding would truncate the
        # Krylov recurrence / reconstruction (see solvers.gmres CGS2 note).
        hp = jax.lax.Precision.HIGHEST
        RS = jnp.matmul(R, S, precision=hp)                    # (m+1, m)
        Rm = R[:m, :m]
        H = jax.scipy.linalg.solve_triangular(
            Rm.T, RS.T, lower=True
        ).T                                                    # (m+1, m)

        # 4. Small least squares via QR of H.
        g = v0norm * R[:, 0]                                   # r0 = V e1
        Qh, Rh = jnp.linalg.qr(H, mode="complete")             # (m+1,m+1)
        gh = jnp.matmul(Qh.T, g, precision=hp)
        y = jax.scipy.linalg.solve_triangular(Rh[:m], gh[:m], lower=False)
        resnorm = jnp.abs(gh[m])

        x_new = x + jnp.matmul(Q[:, :m], y, precision=hp)
        return x_new, resnorm

    def cond(state):
        _, iters, resnorm, converged, stalled = state
        return (~converged) & (~stalled) & (iters < maxiter)

    def body(state):
        x, iters, prev_res, _, _ = state
        x_new, resnorm = cycle(x)
        # true preconditioned residual for the convergence decision
        true_res = jnp.linalg.norm(pre_residual(x_new))
        stalled = ~(true_res < prev_res * (1 - 1e-12)) & (true_res > tol)
        return x_new, iters + m, true_res, true_res <= tol, stalled

    init = (x0, jnp.int32(0), beta0, beta0 <= tol, jnp.asarray(False))
    x, iters, resnorm, converged, _ = jax.lax.while_loop(cond, body, init)
    return GMRESResult(x=x, iters=iters, resnorm=resnorm, converged=converged)
