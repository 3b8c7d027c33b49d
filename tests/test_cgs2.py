"""The GMRES orthogonalization step (solvers.gmres.cgs2_project) against a
float64 numpy Gram-Schmidt."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.solvers.gmres import cgs2_project

M1, N = 31, 257          # restart 30 -> (m+1, n) basis buffer


def _basis(k, rng, garbage=False):
    """(M1, N) buffer whose rows 0..k are orthonormal; rows beyond k are
    zero (the GMRES invariant) or, with garbage=True, random."""
    q, _ = np.linalg.qr(rng.standard_normal((N, k + 1)))
    V = rng.standard_normal((M1, N)) if garbage else np.zeros((M1, N))
    V[: k + 1] = q.T
    return V


def _mgs(V, w, k):
    """Reference: modified Gram-Schmidt of w against rows 0..k."""
    w = w.copy()
    h = np.zeros(M1)
    for i in range(k + 1):
        c = V[i] @ w
        h[i] += c
        w -= c * V[i]
    return w, h


@pytest.mark.parametrize("k", [0, 1, 7, 8, 13, 30])
def test_cgs2_matches_gram_schmidt(k):
    rng = np.random.default_rng(k)
    V = _basis(k, rng)
    w = rng.standard_normal(N)
    w_ref, h_ref = _mgs(V, w, k)
    w_out, h = cgs2_project(jnp.asarray(V), jnp.asarray(w), k)
    np.testing.assert_allclose(np.asarray(h), h_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(w_out), w_ref, rtol=0, atol=1e-12)
    # the result is orthogonal to every live row
    assert np.max(np.abs(V[: k + 1] @ np.asarray(w_out))) < 1e-12


def test_cgs2_ignores_dead_rows():
    """Rows beyond k never enter the projection: with garbage in them the
    coefficients there are exactly zero and the result is unchanged."""
    k = 9
    rng = np.random.default_rng(1)
    V = _basis(k, rng, garbage=True)
    w = rng.standard_normal(N)
    w_out, h = cgs2_project(jnp.asarray(V), jnp.asarray(w), k)
    h = np.asarray(h)
    assert np.all(h[k + 1:] == 0.0)
    w_ref, h_ref = _mgs(V, w, k)
    np.testing.assert_allclose(h[: k + 1], h_ref[: k + 1], atol=1e-12)
    np.testing.assert_allclose(np.asarray(w_out), w_ref, atol=1e-12)
