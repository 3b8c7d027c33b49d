"""Matrix-powers kernels, s-step GMRES, MatrixMarket IO."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.fem.assembly import (
    LINEAR_TERMS,
    assemble_operator,
    build_discretization,
)
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu.mesh import channel_mesh
from navierstokes_tpu.ops.mpk import krylov_basis, matrix_power, matrix_powers_all
from navierstokes_tpu.ops.spmv import spmv_dia
from navierstokes_tpu.solvers.precond import BlockJacobiPreconditioner
from navierstokes_tpu.solvers.sstep import ca_gmres
from navierstokes_tpu.sparse.bcsr import BCSR4
from navierstokes_tpu.sparse.dia import dia_from_bcsr


@pytest.fixture(scope="module")
def system():
    mesh = channel_mesh(3, 2, 2, length=2.0)
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    values = zero_rows_bcsr(
        op.values, disc.row_ids, jnp.asarray(disc.indices), disc.diag_slots,
        disc.bc.row_bc,
    )
    op = BCSR4(indptr=op.indptr, indices=op.indices, values=values)
    dia = dia_from_bcsr(op)
    return disc, op, dia


@pytest.mark.parametrize("k", [2, 3, 4])
def test_matrix_power_vs_chained(system, k):
    """A^k x == k chained SpMVs (the `mpk/SpMVmulti0.cpp:365-416` identity)."""
    disc, op, dia = system
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(disc.ndof))
    y = matrix_power(dia.offsets, dia.data, x, k)
    y_ref = np.asarray(x)
    dense = op.to_dense()
    for _ in range(k):
        y_ref = dense @ y_ref
    rel = np.linalg.norm(np.asarray(y) - y_ref) / np.linalg.norm(y_ref)
    assert rel < 1e-12


def test_matrix_powers_all(system):
    disc, op, dia = system
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(disc.ndof))
    Y = matrix_powers_all(dia.offsets, dia.data, x, 3)
    dense = op.to_dense()
    cur = np.asarray(x)
    for i in range(3):
        cur = dense @ cur
        np.testing.assert_allclose(np.asarray(Y[:, i]), cur, rtol=1e-11,
                                   atol=1e-11)


def test_krylov_basis_recurrence(system):
    """Basis columns satisfy A v_i ~ v_{i+1} (up to recorded normalization)."""
    disc, op, dia = system
    rng = np.random.default_rng(2)
    v = jnp.asarray(rng.standard_normal(disc.ndof))
    V = krylov_basis(dia.offsets, dia.data, v, 4, normalize=True)
    assert V.shape == (disc.ndof, 5)
    for i in range(4):
        av = spmv_dia(dia.offsets, dia.data, V[:, i])
        cos = np.dot(np.asarray(av), np.asarray(V[:, i + 1])) / (
            np.linalg.norm(np.asarray(av))
        )
        np.testing.assert_allclose(cos, 1.0, rtol=1e-10)


def test_ca_gmres_solves(system):
    """s-step GMRES reaches the same solution as a direct solve."""
    disc, op, dia = system
    rhs = disc.bc.value

    def matvec(x):
        return spmv_dia(dia.offsets, dia.data, x)

    pc = BlockJacobiPreconditioner.from_bcsr(op, disc.diag_slots,
                                             matvec=matvec, order=2)
    res = ca_gmres(matvec, rhs, precond=pc, basis=12, rtol=1e-10, atol=1e-12,
                   maxiter=4000)
    assert bool(res.converged)
    x_ref = np.linalg.solve(op.to_dense(), np.asarray(rhs))
    err = np.linalg.norm(np.asarray(res.x) - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-6, f"ca-gmres relative error {err}"


def test_npz_roundtrip(system, tmp_path):
    from navierstokes_tpu.io.mtx import load_bcsr_npz, save_bcsr_npz

    disc, op, dia = system
    path = str(tmp_path / "op.npz")
    save_bcsr_npz(path, op)
    back = load_bcsr_npz(path)
    np.testing.assert_array_equal(back.indptr, op.indptr)
    np.testing.assert_array_equal(back.indices, op.indices)
    np.testing.assert_allclose(np.asarray(back.values), np.asarray(op.values))


def test_monitor_and_nan_guard(capsys):
    """Per-iteration Newton monitor + non-finite abort."""
    import dataclasses

    from navierstokes_tpu.config import NSConfig, SolverConfig
    from navierstokes_tpu.model import NavierStokesSolver

    cfg = NSConfig(dt=0.01, t_final=0.01, reynolds=50.0, delta=0.1,
                   dtype="float64",
                   krylov=SolverConfig(rtol=1e-10, atol=1e-12),
                   stokes_krylov=SolverConfig(rtol=1e-10, atol=1e-12))
    mesh = channel_mesh(3, 2, 2)
    s = NavierStokesSolver(mesh, cfg)
    s.run(1, monitor="newton", check_finite=True)
    out = capsys.readouterr().out
    assert "Newton 00: |F|=" in out
    assert "CONVERGED" in out

    with pytest.raises(FloatingPointError, match="non-finite"):
        s.run(1, u0=jnp.full(s.disc.ndof, jnp.nan), monitor=False,
              check_finite=True)


def test_mtx_by_component(system, tmp_path):
    """The by-component .mtx (`ORDER_BY_COMPONENT`, `src/create_mat.c:55-61`)
    is the block-node matrix under the permutation 4n+c -> n + c*nv."""
    from navierstokes_tpu.io.mtx import read_mtx, write_mtx_by_component

    disc, op, dia = system
    nv = disc.mesh.nv
    path = str(tmp_path / "op_aij.mtx")
    write_mtx_by_component(path, op, nv)
    n, rows, cols, vals = read_mtx(path)
    assert n == disc.ndof
    dense_bc = np.zeros((n, n))
    np.add.at(dense_bc, (rows, cols), vals)
    dense_bn = op.to_dense()
    perm = np.arange(n)
    perm = (perm // 4) + (perm % 4) * nv     # block-node idx -> by-component
    dense_ref = np.zeros((n, n))
    dense_ref[np.ix_(perm, perm)] = dense_bn
    np.testing.assert_allclose(dense_bc, dense_ref, rtol=1e-12, atol=1e-13)


def test_mtx_roundtrip(system, tmp_path):
    from navierstokes_tpu.io.mtx import coo_to_csr, read_mtx, write_mtx

    disc, op, dia = system
    path = str(tmp_path / "op.mtx")
    write_mtx(path, op)
    n, rows, cols, vals = read_mtx(path)
    assert n == disc.ndof
    indptr, csr_cols, csr_vals = coo_to_csr(n, rows, cols, vals)
    dense = np.zeros((n, n))
    for r in range(n):
        for s in range(indptr[r], indptr[r + 1]):
            dense[r, csr_cols[s]] += csr_vals[s]
    np.testing.assert_allclose(dense, op.to_dense(), rtol=1e-12, atol=1e-13)
