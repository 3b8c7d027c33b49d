"""Byte-level parity of the .dat writer with the reference golden corpus."""

import os

import numpy as np
import pytest

from navierstokes_tpu.io.dat import read_petsc_vec, write_petsc_vec
from navierstokes_tpu.ops.spmv import SPMV_VARIANTS, make_spmv

REF_DAT = "/root/reference/res/solution_step0001.dat"


@pytest.mark.skipif(not os.path.exists(REF_DAT), reason="reference corpus absent")
def test_dat_writer_byte_parity_with_reference(tmp_path):
    """Reading a golden PETSc-ASCII file and re-writing it must reproduce the
    file byte-for-byte (header + %g-with-trailing-dot value formatting)."""
    vals = read_petsc_vec(REF_DAT)
    assert len(vals) == 121480
    out = tmp_path / "rewrite.dat"
    write_petsc_vec(str(out), vals)
    with open(REF_DAT, "rb") as f:
        ref_bytes = f.read()
    with open(out, "rb") as f:
        our_bytes = f.read()
    assert our_bytes == ref_bytes


def test_dat_roundtrip_precision(tmp_path):
    rng = np.random.default_rng(0)
    vals = np.concatenate(
        [rng.standard_normal(50) * 10.0 ** rng.integers(-8, 4, 50), [0.0, -0.0]]
    )
    path = tmp_path / "v.dat"
    write_petsc_vec(str(path), vals)
    back = read_petsc_vec(str(path))
    np.testing.assert_allclose(back, vals, rtol=1e-5, atol=1e-300)


def test_spmv_variant_selector():
    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        LINEAR_TERMS,
        assemble_operator,
        build_discretization,
    )
    from navierstokes_tpu.mesh import channel_mesh
    from navierstokes_tpu.sparse.bell import bell_from_bcsr
    from navierstokes_tpu.sparse.dia import dia_from_bcsr

    mesh = channel_mesh(3, 2, 2)
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    ell = bell_from_bcsr(op)
    dia = dia_from_bcsr(op)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(disc.ndof))
    y_ref = np.asarray(make_spmv("oracle", bcsr=op)(x))
    for variant in ("ell", "dia", "plane"):
        y = np.asarray(make_spmv(variant, bcsr=op, ell=ell, dia=dia)(x))
        np.testing.assert_allclose(y, y_ref, rtol=1e-11, atol=1e-12,
                                   err_msg=variant)
    # bf16 operator storage: correct to bf16 roundoff, not f64.
    y16 = np.asarray(make_spmv("dia_bf16", dia=dia)(x))
    ynorm = np.linalg.norm(y_ref)
    assert np.linalg.norm(y16 - y_ref) / ynorm < 2e-2
    with pytest.raises(ValueError, match="unknown spmv variant"):
        make_spmv("avx2")