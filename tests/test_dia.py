"""Scalar-DIA format: conversion, SpMV/SpMM, preconditioner path."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.fem.assembly import (
    LINEAR_TERMS,
    assemble_operator,
    build_discretization,
)
from navierstokes_tpu.mesh import channel_mesh
from navierstokes_tpu.ops.block import block4_apply, block4_inverse
from navierstokes_tpu.ops.spmv import spmv_dia, spmv_dia_multi
from navierstokes_tpu.sparse.dia import (
    block_diag_to_dia,
    dia_from_bcsr,
    dia_values_from_bcsr_values,
)


@pytest.fixture(scope="module")
def fem_op():
    mesh = channel_mesh(4, 3, 3, length=2.0)
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    return disc, op


def test_dia_dense_roundtrip(fem_op):
    disc, op = fem_op
    dia = dia_from_bcsr(op)
    np.testing.assert_allclose(dia.to_dense(), op.to_dense(), rtol=1e-13,
                               atol=1e-14)


def test_dia_spmv_matches_dense(fem_op):
    disc, op = fem_op
    dia = dia_from_bcsr(op)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(disc.ndof))
    y = spmv_dia(dia.offsets, dia.data, x)
    y_ref = op.to_dense() @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-12, atol=1e-12)


def test_dia_spmm_multivector(fem_op):
    disc, op = fem_op
    dia = dia_from_bcsr(op)
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((disc.ndof, 5)))
    Y = spmv_dia_multi(dia.offsets, dia.data, X)
    np.testing.assert_allclose(
        np.asarray(Y), op.to_dense() @ np.asarray(X), rtol=1e-12, atol=1e-12
    )


def test_dia_values_update_path(fem_op):
    """The jittable per-Newton-iteration value update matches full rebuild."""
    disc, op = fem_op
    pat = disc.dia_pattern
    data = dia_values_from_bcsr_values(pat, op.values,
                                       flat_map_dev=disc.dia_flat_map)
    dia_full = dia_from_bcsr(op)
    assert pat.offsets == dia_full.offsets
    np.testing.assert_allclose(np.asarray(data), np.asarray(dia_full.data))


def test_block_diag_to_dia(fem_op):
    disc, op = fem_op
    blocks = op.values[disc.diag_slots]
    inv = block4_inverse(blocks, pivot_eps=1e-300)
    dia = block_diag_to_dia(inv)
    rng = np.random.default_rng(2)
    r = jnp.asarray(rng.standard_normal(disc.ndof))
    np.testing.assert_allclose(
        np.asarray(spmv_dia(dia.offsets, dia.data, r)),
        np.asarray(block4_apply(inv, r)),
        rtol=1e-12, atol=1e-13,
    )



def test_dia_overlapping_scalar_diagonals():
    """Block deltas d1 != d2 can share a scalar diagonal (4*d1+e1 == 4*d2+e2);
    contributions must ADD, not overwrite."""
    from navierstokes_tpu.sparse.bcsr import bcsr_from_coo

    rng = np.random.default_rng(3)
    rows = np.array([0, 0, 1, 1, 2], dtype=np.int32)
    cols = np.array([0, 1, 1, 2, 2], dtype=np.int32)
    blocks = jnp.asarray(rng.standard_normal((5, 4, 4)))
    m = bcsr_from_coo(rows, cols, blocks, 3)
    dia = dia_from_bcsr(m)
    np.testing.assert_allclose(dia.to_dense(), m.to_dense(), rtol=1e-13,
                               atol=1e-14)
