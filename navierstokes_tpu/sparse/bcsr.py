"""Block CSR with 4x4 blocks (BCSR4) — the host-side canonical sparse format.

The device-side analog of the reference's `bcsr4x4_matrix` (`mpk/SpMV.h:25-33`)
and of PETSc's `MATSEQBAIJ` with bs=4. The sparsity pattern is static for a
given mesh (one 4x4 block per adjacent node pair), so the pattern lives in
numpy on the host while values are a device array of shape (nnzb, 4, 4) that
gets recomputed each Newton iteration through a fixed scatter map.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class BCSR4:
    """Block-CSR matrix of (nb x nb) 4x4 blocks.

    indptr:  (nb + 1,) int32 numpy — block-row pointers (static pattern).
    indices: (nnzb,)   int32 numpy — block-column indices, sorted per row.
    values:  (nnzb, 4, 4) device array.
    """

    indptr: np.ndarray
    indices: np.ndarray
    values: jnp.ndarray

    @property
    def nb(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnzb(self) -> int:
        return len(self.indices)

    @property
    def nnz(self) -> int:
        """Scalar nonzero count (for the 2*nnz/t GFLOP/s convention)."""
        return self.nnzb * 16

    @property
    def shape(self):
        return (4 * self.nb, 4 * self.nb)

    def row_ids(self) -> np.ndarray:
        """(nnzb,) block-row index of each stored block."""
        return np.repeat(
            np.arange(self.nb, dtype=np.int32), np.diff(self.indptr)
        )

    def to_dense(self) -> np.ndarray:
        """Dense (4*nb, 4*nb) matrix — small problems / tests only."""
        nb = self.nb
        dense = np.zeros((nb, 4, nb, 4), dtype=np.asarray(self.values).dtype)
        rows = self.row_ids()
        vals = np.asarray(self.values)
        for k in range(self.nnzb):
            dense[rows[k], :, self.indices[k], :] += vals[k]
        return dense.reshape(4 * nb, 4 * nb)

    def diag_slots(self) -> np.ndarray:
        """(nb,) position of each diagonal block in `indices` (must exist)."""
        slots = np.empty(self.nb, dtype=np.int32)
        for r in range(self.nb):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            pos = np.searchsorted(self.indices[lo:hi], r)
            if pos >= hi - lo or self.indices[lo + pos] != r:
                raise ValueError(f"missing diagonal block in row {r}")
            slots[r] = lo + pos
        return slots


def bcsr_pattern_from_coo(rows: np.ndarray, cols: np.ndarray, nb: int):
    """Deduplicated, sorted BCSR pattern from block COO coordinates.

    Returns (indptr, indices, slot_of_coo) where slot_of_coo maps each input
    (row, col) pair to its block slot — the scatter map used by assembly.
    """
    keys = rows.astype(np.int64) * nb + cols.astype(np.int64)
    uniq, slot_of_coo = np.unique(keys, return_inverse=True)
    u_rows = (uniq // nb).astype(np.int32)
    u_cols = (uniq % nb).astype(np.int32)
    indptr = np.zeros(nb + 1, dtype=np.int32)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return indptr, u_cols, slot_of_coo.astype(np.int32)


def bcsr_from_coo(
    rows: np.ndarray, cols: np.ndarray, blocks, nb: int
) -> BCSR4:
    """Assemble a BCSR4 from block-COO triplets, summing duplicates."""
    indptr, indices, slot = bcsr_pattern_from_coo(rows, cols, nb)
    blocks = jnp.asarray(blocks)
    values = jnp.zeros((len(indices), 4, 4), dtype=blocks.dtype)
    values = values.at[jnp.asarray(slot)].add(blocks)
    return BCSR4(indptr=indptr, indices=indices, values=values)
