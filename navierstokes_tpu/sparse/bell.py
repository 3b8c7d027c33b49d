"""Padded block-ELL — a fixed-row-degree on-device operator layout.

Every block-row stores exactly `slots` 4x4 blocks (the max row degree, padded
with zero blocks pointing at the row's own diagonal so gathers stay local).
Fixed row degree means static shapes, regular tiling, and no ragged pointer
chasing — the static-shape replacement for CSR/BCSR row pointers
(SURVEY.md §7 phase 3).  Layout:

  indices: (nb, slots)        int32 block-column of each slot
  values:  (nb, slots, 4, 4)  block values (zero in padding slots)

With RCM node ordering the column span per row tile is bounded by the block
bandwidth (`ops.spmv.spmv_bell_windowed` exploits it with windowed x
loads).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.sparse.bcsr import BCSR4


@dataclasses.dataclass
class BlockELL:
    indices: np.ndarray      # (nb, slots) int32, host-side (static pattern)
    values: jnp.ndarray      # (nb, slots, 4, 4) device array
    nnzb: int                # true (unpadded) block count

    @property
    def nb(self) -> int:
        return self.indices.shape[0]

    @property
    def slots(self) -> int:
        return self.indices.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnzb * 16

    @property
    def shape(self):
        return (4 * self.nb, 4 * self.nb)

    def to_dense(self) -> np.ndarray:
        nb = self.nb
        dense = np.zeros((nb, 4, nb, 4), dtype=np.asarray(self.values).dtype)
        vals = np.asarray(self.values)
        for r in range(nb):
            for s in range(self.slots):
                dense[r, :, self.indices[r, s], :] += vals[r, s]
        return dense.reshape(4 * nb, 4 * nb)


def bell_pattern_from_bcsr(indptr: np.ndarray, indices: np.ndarray, slots=None):
    """(ell_indices, slot_of_bcsr) — pattern + scatter map from BCSR pattern.

    Padding slots point at the row's own index (block bandwidth preserved).
    """
    nb = len(indptr) - 1
    degrees = np.diff(indptr)
    k = int(degrees.max()) if len(degrees) else 0
    if slots is not None:
        if slots < k:
            raise ValueError(f"slots={slots} < max row degree {k}")
        k = slots
    ell_indices = np.repeat(np.arange(nb, dtype=np.int32)[:, None], k, axis=1)
    slot_of_bcsr = np.empty(len(indices), dtype=np.int64)
    for r in range(nb):
        lo, hi = indptr[r], indptr[r + 1]
        d = hi - lo
        ell_indices[r, :d] = indices[lo:hi]
        slot_of_bcsr[lo:hi] = r * k + np.arange(d)
    return ell_indices, slot_of_bcsr


def bell_from_bcsr(m: BCSR4, slots=None) -> BlockELL:
    ell_indices, slot_of_bcsr = bell_pattern_from_bcsr(m.indptr, m.indices, slots)
    nb, k = ell_indices.shape
    vals = jnp.zeros((nb * k, 4, 4), dtype=m.values.dtype)
    vals = vals.at[jnp.asarray(slot_of_bcsr)].set(m.values)
    return BlockELL(
        indices=ell_indices, values=vals.reshape(nb, k, 4, 4), nnzb=m.nnzb
    )


def bell_values_from_bcsr_values(
    bcsr_values: jnp.ndarray, slot_of_bcsr: np.ndarray, nb: int, slots: int
) -> jnp.ndarray:
    """Fast path for value updates when the pattern is fixed (jittable)."""
    vals = jnp.zeros((nb * slots, 4, 4), dtype=bcsr_values.dtype)
    vals = vals.at[jnp.asarray(slot_of_bcsr)].set(bcsr_values)
    return vals.reshape(nb, slots, 4, 4)
