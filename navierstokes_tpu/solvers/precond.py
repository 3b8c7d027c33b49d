"""Preconditioners.

The reference preconditions with ILU(k) + hand-vectorized block triangular
solves (`src/solve_newton.c:1159-1162`, `src/kernels/baij4_solve*.c`).
Sequential triangular solves are hostile to accelerators (SURVEY.md §7 "ILU
parity"), so the default is block-Jacobi built from batched exact 4x4 block
inverses — every application is one batched elementwise 4x4 matvec — optionally
wrapped in a truncated Neumann series to recover some of ILU's strength:

  M^{-1} = sum_{i<=order} (I - D^{-1} A)^i D^{-1}     (order 0 = plain Jacobi)

A block ILU(0) with sequential solves is kept as a host-side (numpy)
correctness oracle; solver-level parity with ILU is validated at the
"same converged solution, different iteration count" level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.ops.block import block4_apply, block4_inverse
from navierstokes_tpu.sparse.bcsr import BCSR4


@dataclasses.dataclass
class BlockJacobiPreconditioner:
    """M^{-1} = blockdiag(A_ii)^{-1}, optionally Neumann-boosted."""

    inv_diag: jnp.ndarray                 # (nb, 4, 4)
    matvec: Optional[Callable] = None     # required if order > 0
    order: int = 0

    @classmethod
    def from_bcsr(cls, m: BCSR4, diag_slots, matvec=None, order=0):
        diag = m.values[diag_slots]
        return cls(
            inv_diag=block4_inverse(diag, pivot_eps=1e-300, shift=1e-8),
            matvec=matvec,
            order=order,
        )

    def __call__(self, r):
        z = block4_apply(self.inv_diag, r)
        acc = z
        for _ in range(self.order):
            # z_{i+1} = z_i + D^{-1}(r - A z_i): Neumann series refinement
            acc = acc + block4_apply(self.inv_diag, r - self.matvec(acc))
        return acc


def _ilu_symbolic_fill(indptr, indices, nb, level):
    """Level-of-fill symbolic ILU(k) pattern on the block graph.

    Standard algorithm: original entries have level 0; a fill entry (i, j)
    created through pivot column c gets level lev(i,c) + lev(c,j) + 1 and is
    kept iff <= `level`.  Returns a new (indptr, indices) with fill included.
    The PETSc `PCFactorSetLevels` analog (`src/solve_newton.c:1162`).
    """
    rows = []
    for i in range(nb):
        rows.append({int(indices[s]): 0 for s in range(indptr[i], indptr[i + 1])})
    for i in range(nb):
        row = rows[i]
        cols_lower = sorted(c for c in row if c < i)
        for c in cols_lower:
            lev_ic = row[c]
            if lev_ic > level:
                continue
            for j, lev_cj in rows[c].items():
                if j <= c:
                    continue
                lev = lev_ic + lev_cj + 1
                if lev <= level and (j not in row or row[j] > lev):
                    row[j] = min(row.get(j, lev), lev)
        rows[i] = {c: l for c, l in row.items() if l <= level}
    new_indptr = np.zeros(nb + 1, dtype=np.int64)
    new_indices = []
    for i in range(nb):
        cols = sorted(rows[i])
        new_indices.extend(cols)
        new_indptr[i + 1] = new_indptr[i] + len(cols)
    return new_indptr, np.asarray(new_indices, dtype=np.int64)


class ILU0Preconditioner:
    """Block ILU(k) on the BCSR4 pattern — host-side numpy correctness oracle.

    Factorization: standard IKJ block algorithm on the level-k fill pattern
    (level=0 reproduces ILU(0)); diagonal blocks stored inverted (like
    PETSc's factored BAIJ).  Solves are sequential forward/backward block
    substitutions — intentionally NOT a device kernel (see module docstring).
    """

    def __init__(self, m: BCSR4, level: int = 0):
        nb = m.nb
        if level > 0:
            indptr, indices = _ilu_symbolic_fill(m.indptr, m.indices, nb, level)
            # Scatter original values into the expanded pattern.
            vals = np.zeros((len(indices), 4, 4), dtype=np.float64)
            src = np.asarray(m.values)
            for i in range(nb):
                lo, hi = indptr[i], indptr[i + 1]
                row_cols = indices[lo:hi]
                for s in range(m.indptr[i], m.indptr[i + 1]):
                    pos = lo + np.searchsorted(row_cols, m.indices[s])
                    vals[pos] = src[s]
            self.indptr, self.indices = indptr, indices
        else:
            self.indptr = m.indptr
            self.indices = m.indices
            vals = np.array(np.asarray(m.values), dtype=np.float64)
        indptr, indices = self.indptr, self.indices

        # slot lookup per row: dict col -> slot
        row_slots = [
            {int(indices[s]): s for s in range(indptr[r], indptr[r + 1])}
            for r in range(nb)
        ]
        inv = np.linalg.inv
        for i in range(nb):
            si, ei = indptr[i], indptr[i + 1]
            for s in range(si, ei):
                k = int(indices[s])
                if k >= i:
                    continue
                dk = row_slots[k][k]
                # L_ik = A_ik @ inv(U_kk)  (U_kk stored inverted already)
                vals[s] = vals[s] @ vals[dk]
                a_ik = vals[s]
                for s2 in range(row_slots[k][k] + 1, indptr[k + 1]):
                    j = int(indices[s2])
                    sij = row_slots[i].get(j)
                    if sij is not None:
                        vals[sij] = vals[sij] - a_ik @ vals[s2]
            di = row_slots[i][i]
            vals[di] = inv(vals[di])

        self.vals = vals
        self.row_slots = row_slots
        self.nb = nb

    def solve_host(self, r: np.ndarray) -> np.ndarray:
        """x = (LU)^{-1} r with unit-diagonal L, inverted-diagonal U."""
        nb = self.nb
        r4 = np.asarray(r, dtype=np.float64).reshape(nb, 4)
        y = np.zeros_like(r4)
        indptr, indices, vals = self.indptr, self.indices, self.vals
        for i in range(nb):
            acc = r4[i].copy()
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j < i:
                    acc -= vals[s] @ y[j]
            y[i] = acc
        x = np.zeros_like(r4)
        for i in range(nb - 1, -1, -1):
            acc = y[i].copy()
            di = None
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j > i:
                    acc -= vals[s] @ x[j]
                elif j == i:
                    di = s
            x[i] = vals[di] @ acc
        return x.reshape(-1)

    def solve_host_transpose(self, r: np.ndarray) -> np.ndarray:
        """x = (LU)^{-T} r — the transposed block triangular solves.

        Counterpart of the reference's MatSolveTranspose kernel
        (`src/kernels/baij4_factor_avx2.c:399-498`): (LU)^T = U^T L^T, so
        first a forward sweep with U^T (lower triangular; the stored inverted
        diagonal transposes into the inverted diagonal of U^T), then a
        backward sweep with the unit-diagonal L^T.  Both sweeps scatter each
        computed block down/up the columns — the CSR-transpose saxpy form.
        """
        nb = self.nb
        indptr, indices, vals = self.indptr, self.indices, self.vals
        work = np.array(np.asarray(r, dtype=np.float64).reshape(nb, 4))
        y = np.zeros_like(work)
        for i in range(nb):                     # U^T y = r (forward)
            di = self.row_slots[i][i]
            y[i] = vals[di].T @ work[i]
            for s in range(di + 1, indptr[i + 1]):
                work[int(indices[s])] -= vals[s].T @ y[i]
        x = np.zeros_like(work)
        for i in range(nb - 1, -1, -1):         # L^T x = y (backward)
            x[i] = y[i]
            for s in range(indptr[i], indptr[i + 1]):
                j = int(indices[s])
                if j >= i:
                    break
                y[j] -= vals[s].T @ x[i]
        return x.reshape(-1)

    def __call__(self, r, transpose: bool = False):
        # Works inside jitted/while_loop'd solvers via a host callback (CPU
        # oracle path only — never the accelerator performance path).
        import jax

        solve = self.solve_host_transpose if transpose else self.solve_host

        def cb(rr):
            return solve(np.asarray(rr)).astype(rr.dtype)

        return jax.pure_callback(
            cb, jax.ShapeDtypeStruct(r.shape, r.dtype), r
        )


# ILU with levels is the same class; keep the historical name as an alias.
ILUPreconditioner = ILU0Preconditioner


def make_preconditioner(
    kind: str, m: BCSR4, diag_slots, matvec=None, order=0, level=0
):
    if kind == "none" or kind is None:
        return None
    if kind == "block_jacobi":
        return BlockJacobiPreconditioner.from_bcsr(
            m, diag_slots, matvec=matvec, order=order
        )
    if kind == "ilu0":
        return ILU0Preconditioner(m, level=0)
    if kind == "ilu":
        return ILU0Preconditioner(m, level=level)
    raise ValueError(f"unknown preconditioner {kind!r}")
