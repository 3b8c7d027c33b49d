"""Newton-basis (Leja-shifted) CA-GMRES (solvers/sstep.py).

The monomial s-step basis conditions like kappa(A)^m and stalls in f32
(measured at 117k rows: every basis length 6-16 stalls); the Newton
basis is the textbook fix.  Pinned here at three levels: the Leja ordering
itself, a synthetic f32 stall the shifts demonstrably cure, the shifted
one-exchange matrix-powers kernel, and the model-level ca_basis='newton'
path reaching the standard-GMRES state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.solvers.sstep import ca_gmres, leja_order, newton_shifts


def test_leja_order_properties():
    rng = np.random.default_rng(7)
    v = rng.standard_normal(20) * 10
    out = leja_order(v)
    assert sorted(out) == sorted(v)                  # a permutation
    assert abs(out[0]) == np.abs(v).max()            # starts at max modulus
    # each point maximizes the distance product to its predecessors among
    # the remaining candidates (greedy invariant, checked at step 1)
    rest = [x for x in v if x != out[0]]
    d1 = [abs(x - out[0]) for x in rest]
    assert abs(out[1] - out[0]) == max(d1)


def test_newton_shifts_from_hessenberg():
    rng = np.random.default_rng(3)
    m = 12
    h = np.triu(rng.standard_normal((m + 1, m)), -1)   # Hessenberg
    s = newton_shifts(h, 8)
    assert len(s) == 8
    theta = np.real(np.linalg.eigvals(h[:m, :m]))
    assert abs(s[0]) == pytest.approx(np.abs(theta).max(), rel=1e-12)
    s_long = newton_shifts(h, 2 * m + 3)               # cycling
    assert len(s_long) == 2 * m + 3
    assert s_long[:m] == s_long[m:2 * m]


def test_newton_basis_cures_f32_monomial_stall():
    """Wide-spectrum SPD diagonal in f32: the monomial basis at m=12 stalls
    (normalized powers align, QR goes numerically rank-deficient), the
    Leja-shifted Newton basis converges.  This is the 117k-row f32 stall
    in miniature."""
    n, m = 2048, 12
    # kappa = 1e3: standard GMRES(12) needs ~310 iterations here; the
    # Newton basis matches it (~312, measured) while the monomial basis
    # stalls within 3 cycles.  maxiter leaves ~4x headroom.
    d = np.logspace(0, 3, n).astype(np.float32)
    diag = jnp.asarray(d)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)

    def matvec(x):
        return diag * x

    res_mono = ca_gmres(matvec, b, basis=m, rtol=1e-4, atol=0.0,
                        maxiter=1200)
    # Ritz values of the diagonal operator via a real Arnoldi sweep
    from navierstokes_tpu.solvers.deflation import arnoldi

    _, h = jax.jit(lambda r: arnoldi(matvec, r, 32))(b)
    shifts = newton_shifts(np.asarray(h, np.float64), m)
    res_newt = ca_gmres(matvec, b, basis=m, rtol=1e-4, atol=0.0,
                        maxiter=1200, shifts=shifts)
    assert bool(res_newt.converged), "newton basis must converge"
    # the cure is real: monomial stalls or needs far more iterations
    assert (not bool(res_mono.converged)) or (
        int(res_newt.iters) < int(res_mono.iters))
    x = np.asarray(res_newt.x)
    rel = np.linalg.norm(d * x - np.asarray(b)) / np.linalg.norm(b)
    assert rel < 1e-3


def test_shifted_power_kernel_matches_chained():
    """partitioned_spmv_dia_power(shifts=...) == chained (A - theta I)
    applications on 8 devices."""
    from navierstokes_tpu.parallel.partitioned import (
        partitioned_spmv_dia_power,
    )

    ndev = min(8, len(jax.devices()))
    if ndev < 2:
        pytest.skip("needs >= 2 devices")
    from jax.sharding import Mesh

    dmesh = Mesh(np.array(jax.devices()[:ndev]), ("x",))
    n = 64 * ndev
    offsets = (-3, -1, 0, 1, 3)
    rng = np.random.default_rng(5)
    data = np.zeros((len(offsets), n))
    for k, dd in enumerate(offsets):
        lo, hi = max(0, -dd), n - max(0, dd)
        data[k, lo:hi] = rng.standard_normal(hi - lo)
    x = rng.standard_normal(n)
    shifts = (0.7, -1.3, 0.25)

    def dense_apply(v):
        y = np.zeros_like(v)
        for k, dd in enumerate(offsets):
            lo, hi = max(0, -dd), n - max(0, dd)
            y[lo:hi] += data[k, lo:hi] * v[lo + dd:hi + dd]
        return y

    want = []
    cur = x.copy()
    for t in shifts:
        cur = dense_apply(cur) - t * cur
        want.append(cur.copy())
    want = np.stack(want, axis=-1)

    got = partitioned_spmv_dia_power(
        dmesh, "x", offsets, jnp.asarray(data), jnp.asarray(x), ndev,
        len(shifts), return_all=True, shifts=shifts,
    )
    assert np.allclose(np.asarray(got), want, atol=1e-10)


def test_ca_basis_newton_in_model():
    """model-level ca_basis='newton' reaches the standard-GMRES state."""
    from navierstokes_tpu.config import NSConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = channel_mesh(3, 2, 2, length=2.0)
    base = NSConfig(
        dt=0.01, t_final=0.03, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                            preconditioner="two_level", coarse_agg=4),
        stokes_krylov=SolverConfig(rtol=1e-13, atol=1e-13, maxiter=4000,
                                   preconditioner="two_level", coarse_agg=4),
    )
    s0 = NavierStokesSolver(mesh, base)
    u0 = s0.stokes_init()
    u_ref, _, st0 = s0.step(u0, u0, jnp.zeros_like(u0))
    assert bool(st0.converged)

    kr = dataclasses.replace(base.krylov, method="ca_gmres", restart=8,
                             ca_basis="newton", rtol=1e-10)
    cfg = dataclasses.replace(base, krylov=kr)
    s = NavierStokesSolver(mesh, cfg)
    u0n = s.stokes_init()
    s._ensure_prepared()
    assert len(s._ca_shifts) == 8
    u, _, st = s.step(u0n, u0n, jnp.zeros_like(u0n))
    assert bool(st.converged)
    err = np.linalg.norm(np.asarray(u) - np.asarray(u_ref)) / (
        np.linalg.norm(np.asarray(u_ref)))
    assert err < 1e-6, f"newton-basis ca_gmres disagreement {err}"


def test_ca_basis_validation():
    from navierstokes_tpu.config import NSConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = channel_mesh(2, 2, 2)
    kr = SolverConfig(ca_basis="bogus")
    with pytest.raises(ValueError, match="ca_basis"):
        NavierStokesSolver(mesh, NSConfig(krylov=kr))
    kr2 = SolverConfig(method="ca_gmres", ca_basis="newton")
    with pytest.raises(ValueError, match="exact"):
        NavierStokesSolver(
            mesh, NSConfig(krylov=kr2, jacobian="reference"))
