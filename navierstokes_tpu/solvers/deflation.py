"""Krylov subspace recycling: GCRO-style spectral deflation.

The round-3 review's last scaling cost is ITERATION-COUNT growth (mean lin
69 -> 117 -> 148 -> 253 over 117k -> 2.35M rows, each iteration a
memory-bound sweep).  The exact-Jacobian operator is CONSTANT across Newton
iterations AND time steps — the ideal case for recycling: compute an
approximate near-kernel subspace ONCE at operator preparation, then solve
every system in the complement.

Design (GCRO / GCRO-DR family, Parks et al. 2006, recycle-once variant):

  setup  (eager, once per prepared operator):
    1. m-step CGS2 Arnoldi on the PRECONDITIONED operator T = M^{-1}A:
       T V_m = V_{m+1} Hbar.
    2. Harmonic Ritz pairs of Hbar on the host (m x m eig — tiny); keep the
       k smallest-|theta| vectors: the modes that stall restarted GMRES.
    3. W = V_m Y;  C = T W = V_{m+1} (Hbar Y)  (free via the Arnoldi
       relation — no extra matvecs);  QR: C = Q R;  U = W R^{-1}, so
       T U = Q with Q^T Q = I.
  solve  (each Newton/GMRES call, model._solve_deflated):
       x = y + U (Q^T (b - T y)),  y from GMRES on the deflated operator
       (I - Q Q^T) T with rhs (I - Q Q^T) b — the Krylov iteration never
       sees the recycled directions, and the final correction solves them
       exactly.  True preconditioned residual == the inner GMRES residual
       (algebraic identity), so convergence semantics carry over.

Per-iteration overhead: two (k, n) GEMVs (the Q-projection) on top of
CGS2's four (m+1, n) — at k=16, ~+13% of the orthogonalization traffic.
Reference match: this plays ILU(4)'s role as the iteration-count
suppressor (`/root/reference/src/solve_newton.c:1154-1164`), re-expressed
as a setup-time spectral computation instead of a sequential triangular
factorization.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def arnoldi(matvec: Callable, v0: jnp.ndarray, m: int):
    """m-step Arnoldi with CGS2 orthogonalization (the same fused-GEMV
    scheme as solvers.gmres).  Returns (V, Hbar): V (m+1, n) row-major
    orthonormal basis, Hbar (m+1, m) upper Hessenberg with
    matvec(V[:m].T) = V.T @ Hbar."""
    n = v0.shape[0]
    dtype = v0.dtype
    hp = jax.lax.Precision.HIGHEST
    beta = jnp.linalg.norm(v0)
    V = jnp.zeros((m + 1, n), dtype).at[0].set(
        v0 / jnp.where(beta > 0, beta, 1.0)
    )
    H = jnp.zeros((m + 1, m), dtype)

    def body(k, carry):
        V, H = carry
        w = matvec(V[k])
        active = (jnp.arange(m + 1) <= k).astype(dtype)
        h1 = jnp.matmul(V, w, precision=hp) * active
        w = w - jnp.matmul(V.T, h1, precision=hp)
        h2 = jnp.matmul(V, w, precision=hp) * active
        w = w - jnp.matmul(V.T, h2, precision=hp)
        h = h1 + h2
        hk1 = jnp.linalg.norm(w)
        V = V.at[k + 1].set(w / jnp.where(hk1 > 0, hk1, 1.0))
        H = H.at[:, k].set(h.at[k + 1].set(hk1))
        return V, H

    return jax.lax.fori_loop(0, m, body, (V, H))


def harmonic_ritz_basis(Hbar: np.ndarray, k: int) -> np.ndarray:
    """Host-side (f64) harmonic Ritz extraction from the Arnoldi Hessenberg.

    Harmonic Ritz pairs (theta, y) of the operator restricted to the Krylov
    space satisfy (H_m + h_{m+1,m}^2 H_m^{-T} e_m e_m^T) y = theta y; the
    SMALLEST |theta| approximate the eigenvalues closest to zero — exactly
    the modes that dominate restarted-GMRES stagnation.  Complex pairs
    contribute their real and imaginary parts (one conjugate per pair).
    Returns a real orthonormal Y (m, k') with k' <= k.
    """
    Hbar = np.asarray(Hbar, dtype=np.float64)
    m = Hbar.shape[1]
    H = Hbar[:m]
    h2 = float(Hbar[m, m - 1]) ** 2
    em = np.zeros(m)
    em[-1] = 1.0
    try:
        f = np.linalg.solve(H.T, em)
    except np.linalg.LinAlgError:
        f = np.linalg.lstsq(H.T, em, rcond=None)[0]
    theta, Yc = np.linalg.eig(H + h2 * np.outer(f, em))

    order = np.argsort(np.abs(theta))
    cols = []
    used = set()
    for idx in order:
        if len(cols) >= k:
            break
        if idx in used:
            continue
        used.add(int(idx))
        th, y = theta[idx], Yc[:, idx]
        if abs(th.imag) > 1e-12 * max(abs(th), 1e-300):
            cols.append(y.real)
            cols.append(y.imag)
            # retire the conjugate partner (same invariant plane)
            d = np.abs(theta - np.conj(th))
            d[list(used)] = np.inf
            used.add(int(np.argmin(d)))
        else:
            cols.append(y.real)
    Y = np.stack(cols[:k], axis=1)
    Y, _ = np.linalg.qr(Y)
    return Y


def recycle_space(V, Hbar, Y):
    """Device-side assembly of the recycled pair (U, Q), both (k, n)
    row-major:  T U_mat = Q_mat with Q_mat^T Q_mat = I (columns = rows
    here).  Jit-friendly: called once at prepare time."""
    hp = jax.lax.Precision.HIGHEST
    m = Hbar.shape[1]
    W = jnp.matmul(Y.T, V[:m], precision=hp)              # (k, n) = (V_m Y)^T
    HY = jnp.matmul(Hbar, Y, precision=hp)                # (m+1, k)
    C = jnp.matmul(HY.T, V, precision=hp)                 # (k, n) = (T W)^T
    Qt, R = jnp.linalg.qr(C.T)                            # C^T = Qt R
    # U_mat = W_mat R^{-1}  <=>  rows: U = R^{-T} W
    U = jax.scipy.linalg.solve_triangular(R.T, W, lower=True)
    return U, Qt.T
