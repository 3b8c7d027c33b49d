"""Scalar diagonal (DIA) storage — the gather-free scalar operator layout.

SpMV in this format is K unrolled fused multiply-adds over contiguous
(ndof,) vectors with statically shifted slices: zero gathers, coalesced
streams, memory-bandwidth-bound (block-ELL needs a gather per block).

Why it applies: after band (RCM / lexicographic) node ordering a FEM operator
has few distinct column offsets.  The 4x4-blocked NS operator with block
deltas {d} yields scalar diagonals {4d + e, e in [-3, 3]} — ~81 for the
channel meshes, a 1.35x storage inflation over raw blocks.  The sparsity
PATTERN is static per mesh, so the (k_diag, scalar_row) scatter map from
BCSR block values is precomputed once and each Newton iteration's value
update is a single fused scatter-add under jit.

This replaces the role of the reference's hand-vectorized BCSR4 AVX2 kernels
(`src/kernels/baij4_avx2.c`, `mpk/SpMV.cpp`) — same math, layout chosen for
wide vector streams instead of 4-wide SIMD registers.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.sparse.bcsr import BCSR4


@dataclasses.dataclass
class ScalarDIA:
    """offsets: (K,) sorted scalar diagonals; data: (K, ndof) device array.

    data[k, i] = A[i, i + offsets[k]] (zero where outside the pattern).
    """

    offsets: tuple               # static python ints (jit-stable)
    data: jnp.ndarray            # (K, ndof)
    nnz: int                     # true scalar nonzeros (for GFLOP/s)

    @property
    def ndof(self) -> int:
        return self.data.shape[1]

    @property
    def halo(self) -> int:
        return max(abs(d) for d in self.offsets) if self.offsets else 0

    def to_dense(self) -> np.ndarray:
        n = self.ndof
        dense = np.zeros((n, n), dtype=np.asarray(self.data).dtype)
        data = np.asarray(self.data)
        for k, d in enumerate(self.offsets):
            rows = np.arange(max(0, -d), min(n, n - d))
            dense[rows, rows + d] = data[k, rows]
        return dense


@dataclasses.dataclass
class DIAPattern:
    """Static scatter map: BCSR block values -> DIA data (precomputed once)."""

    offsets: tuple
    ndof: int
    flat_map: np.ndarray         # (nnzb*16,) int: k*ndof + scalar_row
    nnz: int
    # Static plan for block-row scaling S = D^{-1} A (see scale_rows_dia):
    # scaled_offsets[k'] collects terms (e, k) with offsets[k] + e == target.
    scaled_offsets: tuple = ()
    scaled_terms: tuple = ()     # tuple of tuples of (e, k)

    @property
    def K(self) -> int:
        return len(self.offsets)


def build_dia_pattern(indptr: np.ndarray, indices: np.ndarray) -> DIAPattern:
    """Derive the scalar-diagonal pattern from a BCSR4 block pattern."""
    nb = len(indptr) - 1
    ndof = 4 * nb
    rows = np.repeat(np.arange(nb, dtype=np.int64), np.diff(indptr))
    cols = indices.astype(np.int64)
    bdelta = cols - rows                                    # (nnzb,)

    e = (np.arange(4)[None, :] - np.arange(4)[:, None])     # (a, b): b - a
    deltas = 4 * bdelta[:, None, None] + e[None, :, :]      # (nnzb, 4, 4)
    offsets = np.unique(deltas)
    k_of = np.searchsorted(offsets, deltas)                 # (nnzb, 4, 4)
    scalar_row = 4 * rows[:, None, None] + np.arange(4)[None, :, None]
    flat_map = (k_of * ndof + scalar_row).reshape(-1)

    # Static plan for S = D^{-1} A: result diagonal d' = e + d for e in
    # [-3, 3], d in offsets.
    off_list = [int(d) for d in offsets]
    off_set = set(off_list)
    targets = sorted({d + ee for d in off_list for ee in range(-3, 4)})
    terms = []
    kept_targets = []
    for t in targets:
        tt = tuple(
            (ee, off_list.index(t - ee))
            for ee in range(-3, 4)
            if (t - ee) in off_set
        )
        if tt:
            kept_targets.append(t)
            terms.append(tt)

    return DIAPattern(
        offsets=tuple(off_list),
        ndof=ndof,
        flat_map=flat_map.astype(np.int64),
        nnz=len(rows) * 16,
        scaled_offsets=tuple(kept_targets),
        scaled_terms=tuple(terms),
    )


def dia_values_from_bcsr_values(
    pattern: DIAPattern, bcsr_values: jnp.ndarray, flat_map_dev=None
) -> jnp.ndarray:
    """(nnzb, 4, 4) block values -> (K, ndof) diagonal data. Jittable."""
    fm = jnp.asarray(pattern.flat_map) if flat_map_dev is None else flat_map_dev
    flat = jnp.zeros(pattern.K * pattern.ndof, dtype=bcsr_values.dtype)
    flat = flat.at[fm].add(bcsr_values.reshape(-1))
    return flat.reshape(pattern.K, pattern.ndof)


def zero_rows_dia(offsets: tuple, data, is_bc):
    """Functional `MatZeroRows(..., 1.0)` directly on DIA data.

    is_bc: (ndof,) bool.  Zeroes constrained scalar rows and sets their
    diagonal entry to 1 — no block-form detour, no layout-padded arrays.
    """
    data = jnp.where(is_bc[None, :], jnp.zeros((), data.dtype), data)
    k0 = offsets.index(0)
    data = data.at[k0].set(
        jnp.where(is_bc, jnp.ones((), data.dtype), data[k0])
    )
    return data


def diag_blocks_from_dia(offsets: tuple, data, nb: int):
    """Extract the (nb, 4, 4) block diagonal from DIA data.

    D[r, a, b] lives on scalar diagonal e = b - a at row 4r + a.
    """
    out = jnp.zeros((nb, 4, 4), dtype=data.dtype)
    for e in range(-3, 4):
        if e not in offsets:
            continue
        row = data[offsets.index(e)].reshape(nb, 4)   # [r, a] = (4r+a, +e)
        for a in range(4):
            b = a + e
            if 0 <= b < 4:
                out = out.at[:, a, b].set(row[:, a])
    return out


def dia_from_bcsr(m: BCSR4) -> ScalarDIA:
    pattern = build_dia_pattern(m.indptr, m.indices)
    return ScalarDIA(
        offsets=pattern.offsets,
        data=dia_values_from_bcsr_values(pattern, m.values),
        nnz=pattern.nnz,
    )


def _shift(v, e):
    """shift(v, e)[i] = v[i + e] (zero fill)."""
    if e == 0:
        return v
    n = v.shape[0]
    return jax.lax.dynamic_slice(jnp.pad(v, (4, 4)), (4 + e,), (n,))


def scale_rows_dia(pattern: DIAPattern, data, inv_blocks):
    """S = D^{-1} A in DIA form (jittable).

    Folds the block-Jacobi preconditioner INTO the operator so every
    left-preconditioned GMRES iteration costs exactly one DIA SpMV instead of
    matvec + preconditioner applies.  inv_blocks: (nb, 4, 4) inverted diagonal
    blocks.  Uses the static (scaled_offsets, scaled_terms) plan:

        S_data[t][i] = sum_e  Dinv[i, i+e] * data[k_{t-e}][i + e]

    Returns (scaled_offsets, scaled_data) with scaled_data (K', ndof).
    """
    invd = block_diag_to_dia(inv_blocks).data          # (7, ndof), e = k-3
    out = []
    for terms in pattern.scaled_terms:
        acc = None
        for e, k in terms:
            term = invd[e + 3] * _shift(data[k], e)
            acc = term if acc is None else acc + term
        out.append(acc)
    return pattern.scaled_offsets, jnp.stack(out)


def block_diag_to_dia(blocks: jnp.ndarray) -> ScalarDIA:
    """(nb, 4, 4) block-diagonal matrix -> 7-diagonal ScalarDIA.

    Used for the block-Jacobi preconditioner apply, which is itself a
    block-diagonal SpMV and benefits from the same lane-major layout.
    """
    nb = blocks.shape[0]
    ndof = 4 * nb
    offsets = tuple(range(-3, 4))
    data = jnp.zeros((7, ndof), dtype=blocks.dtype)
    for a in range(4):
        for b in range(4):
            d = b - a
            k = d + 3
            rows = 4 * jnp.arange(nb) + a
            data = data.at[k, rows].set(blocks[:, a, b])
    return ScalarDIA(offsets=offsets, data=data, nnz=nb * 16)
