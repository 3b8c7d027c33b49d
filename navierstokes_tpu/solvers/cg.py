"""Preconditioned conjugate gradients as a jitted `lax.while_loop`.

For the SPD configurations (pressure-Poisson solves in BASELINE.json's config
list).  Convergence follows PETSc `KSPConvergedDefault` with the natural
M-inner-product residual norm: sqrt(r . M^{-1} r) < max(rtol * norm0, atol).
"""

from __future__ import annotations


from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

HP = jax.lax.Precision.HIGHEST


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray


def _identity(x):
    return x


def cg(
    matvec: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    *,
    precond: Optional[Callable] = None,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 2000,
) -> CGResult:
    M = precond or _identity
    x0 = jnp.zeros_like(b) if x0 is None else x0

    r0 = b - matvec(x0)
    z0 = M(r0)
    rz0 = jnp.dot(r0, z0, precision=HP)
    norm0 = jnp.sqrt(jnp.abs(rz0))
    tol = jnp.maximum(rtol * norm0, atol)

    def cond(state):
        _, _, _, rz, iters, resnorm = state
        return (resnorm > tol) & (iters < maxiter)

    def body(state):
        x, r, p, rz, iters, _ = state
        Ap = matvec(p)
        alpha = rz / jnp.dot(p, Ap, precision=HP)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.dot(r, z, precision=HP)
        beta = rz_new / rz
        p = z + beta * p
        return x, r, p, rz_new, iters + 1, jnp.sqrt(jnp.abs(rz_new))

    state = (x0, r0, z0, rz0, jnp.int32(0), norm0)
    x, _, _, _, iters, resnorm = jax.lax.while_loop(cond, body, state)
    return CGResult(x=x, iters=iters, resnorm=resnorm, converged=resnorm <= tol)
