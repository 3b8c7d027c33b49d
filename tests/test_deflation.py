"""Krylov subspace recycling (solvers/deflation.py): algebra + end-to-end.

The reference suppresses iteration counts with ILU(4)
(`src/solve_newton.c:1154-1164`); this design recycles a harmonic-Ritz
subspace of the constant preconditioned operator instead.  These tests pin
the algebraic identities (Arnoldi relation, T U = Q, exact recycled
correction) and the solver-level contract (same solution, converged).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.config import NSConfig, SolverConfig
from navierstokes_tpu.mesh import channel_mesh
from navierstokes_tpu.model import NavierStokesSolver
from navierstokes_tpu.solvers.deflation import (
    arnoldi,
    harmonic_ritz_basis,
    recycle_space,
)


def _random_operator(n=60, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    # plant a few small eigenvalues (the modes deflation should capture)
    w, V = np.linalg.eig(A)
    idx = np.argsort(np.abs(w))[:4]
    w[idx] = w[idx] * 0.02
    A = (V @ np.diag(w) @ np.linalg.inv(V)).real
    return jnp.asarray(A), rng


def test_arnoldi_relation_and_orthonormality():
    A, rng = _random_operator()
    v0 = jnp.asarray(rng.standard_normal(A.shape[0]))
    m = 20
    V, H = arnoldi(lambda x: A @ x, v0, m)
    # orthonormal basis
    G = np.asarray(V @ V.T)
    np.testing.assert_allclose(G, np.eye(m + 1), atol=1e-12)
    # T V_m = V_{m+1} Hbar
    lhs = np.asarray((A @ V[:m].T))
    rhs = np.asarray(V.T @ H)
    np.testing.assert_allclose(lhs, rhs, atol=1e-12)


def test_recycle_space_identities():
    A, rng = _random_operator()
    v0 = jnp.asarray(rng.standard_normal(A.shape[0]))
    m, k = 30, 6
    V, H = arnoldi(lambda x: A @ x, v0, m)
    Y = jnp.asarray(harmonic_ritz_basis(np.asarray(H), k))
    U, Q = recycle_space(V, H, Y)
    assert U.shape == Q.shape == (k, A.shape[0])
    # Q^T Q = I (rows orthonormal)
    np.testing.assert_allclose(np.asarray(Q @ Q.T), np.eye(k), atol=1e-10)
    # T U_mat = Q_mat
    np.testing.assert_allclose(
        np.asarray(A @ U.T), np.asarray(Q.T), atol=1e-9
    )


def test_harmonic_ritz_finds_small_eigenvalues():
    # full-length Arnoldi on a small operator: harmonic Ritz values are the
    # exact eigenvalues, so the selected subspace must span the small ones.
    A, rng = _random_operator(n=24, seed=3)
    v0 = jnp.asarray(rng.standard_normal(24))
    m = 23
    V, H = arnoldi(lambda x: A @ x, v0, m)
    Y = harmonic_ritz_basis(np.asarray(H), 4)
    W = np.asarray(V[:m]).T @ Y                 # (n, k) recycled directions
    # ||A w|| / ||w|| must be small for the recycled directions
    ratios = np.linalg.norm(np.asarray(A) @ W, axis=0) / np.linalg.norm(
        W, axis=0
    )
    An = np.asarray(A)
    small = np.sort(np.abs(np.linalg.eigvals(An)))[:4]
    assert ratios.max() < 20 * small.max() + 1e-8, (ratios, small)


def _cfg(spmv="auto", **kw):
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4,
                      spmv=spmv, **kw)
    return NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=kr, stokes_krylov=dataclasses.replace(kr, deflation_k=0),
    )


@pytest.mark.parametrize("spmv", ["auto", "plane"])
def test_deflated_solver_matches_undeflated(spmv):
    mesh = channel_mesh(8, 3, 3, length=4.0)
    base = NavierStokesSolver(mesh, _cfg(spmv))
    u_base = base.run(2, monitor=False)

    defl = NavierStokesSolver(
        mesh, _cfg(spmv, deflation_k=6, deflation_arnoldi=24)
    )
    assert defl._exact_prep[0] == "defl"
    u_defl = defl.run(2, monitor=False)

    err = np.linalg.norm(np.asarray(u_defl) - np.asarray(u_base)) / (
        np.linalg.norm(np.asarray(u_base))
    )
    assert err < 1e-8, f"deflated vs plain solution drift ({spmv}): {err}"


def test_deflation_reduces_iterations():
    """On the small operator the recycled space must not INCREASE the
    iteration count (whether it wins at scale is a benchmark question; this
    guards the implementation-level contract)."""
    mesh = channel_mesh(8, 3, 3, length=4.0)
    u0 = None
    counts = {}
    for k in (0, 8):
        cfg = _cfg("auto", deflation_k=k, deflation_arnoldi=32)
        s = NavierStokesSolver(mesh, cfg)
        if u0 is None:
            u0 = s.stokes_init()
        u, du, stats = s.step(u0, u0, jnp.zeros_like(u0))
        assert bool(stats.converged)
        counts[k] = int(stats.lin_iters)
    assert counts[8] <= counts[0], counts


def test_deflation_requires_exact_jacobian():
    mesh = channel_mesh(6, 2, 2)
    cfg = dataclasses.replace(_cfg("auto", deflation_k=4),
                              jacobian="reference")
    s = NavierStokesSolver(mesh, cfg)
    with pytest.raises(ValueError, match="deflation"):
        s._ensure_prepared()


def test_deflation_requires_gmres_method():
    mesh = channel_mesh(6, 2, 2)
    cfg = _cfg("auto", deflation_k=4, method="ca_gmres")
    s = NavierStokesSolver(mesh, cfg)
    with pytest.raises(ValueError, match="gmres"):
        s._ensure_prepared()


def test_deflation_rejected_distributed():
    from navierstokes_tpu.parallel import DistributedNavierStokesSolver

    mesh = channel_mesh(12, 2, 2, length=6.0)
    s, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, _cfg("auto", deflation_k=4), devices=jax.devices()[:4]
    )
    with pytest.raises(ValueError, match="single-chip"):
        s._ensure_prepared()
