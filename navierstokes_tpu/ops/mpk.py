"""Matrix-powers kernels: A^k x and s-step Krylov basis construction.

The JAX re-expression of the reference's communication-avoiding mpk suite
(SURVEY.md §2.2 #25-27): `Generate1stlayer`/`Generate2ndlayer`/... build
ragged dependency-pointer tables so SpM2V/SpM3V/SpM4V compute A^2x/A^3x/A^4x
in one sweep over the matrix (`mpk/SpM2V.cpp`, `mpk/SpMVmulti0.cpp`).

Here the same idea splits across two levels:

- **within a device** `matrix_power` chains the DIA SpMV inside one jitted
  computation (one dispatch, XLA-scheduled); a fused single-sweep A^p x
  only pays where the operator fits in cache between sweeps,
- **across devices** the communication-avoiding structure is real:
  `parallel.partitioned.partitioned_spmv_power` exchanges a k-deep ghost
  layer ONCE and runs k local sweeps — one exchange round instead of k.

`krylov_basis` is the `BuildKrylovBasis_AVX2` equivalent
(`src/kernels/spmm_avx2.c:112-168`): builds [v, Av, A^2 v, ..., A^s v]
column-major for the s-step GMRES of `solvers/sstep.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from navierstokes_tpu.ops.spmv import spmv_dia


def matrix_power(offsets, data, x, k: int):
    """A^k x by k chained DIA SpMVs in one jitted computation."""
    y = x
    for _ in range(k):
        y = spmv_dia(offsets, data, y)
    return y


def matrix_powers_all(offsets, data, x, k: int):
    """[A x, A^2 x, ..., A^k x] stacked along axis 1: (ndof, k)."""
    ys = []
    y = x
    for _ in range(k):
        y = spmv_dia(offsets, data, y)
        ys.append(y)
    return jnp.stack(ys, axis=1)


def krylov_basis(offsets, data, v, s: int, *, normalize: bool = False):
    """Monomial Krylov basis [v, Av, ..., A^s v]: (ndof, s+1).

    With normalize=True each column is scaled to unit norm as it is produced
    (mitigates the monomial basis' conditioning, cf. the orthogonalization
    hooks in `mpk/2SpMV.cpp:3-28`).
    """
    cols = [v]
    y = v
    for _ in range(s):
        y = spmv_dia(offsets, data, y)
        if normalize:
            y = y / jnp.linalg.norm(y)
        cols.append(y)
    return jnp.stack(cols, axis=1)
