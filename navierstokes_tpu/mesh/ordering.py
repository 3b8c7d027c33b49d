"""Node reordering for locality.

Accelerator sparse kernels live or die by locality (SURVEY.md §7 "hard
parts"): with reverse-Cuthill–McKee ordering the FEM operator becomes banded,
so a row's column references fall inside a bounded window — the property the
DIA / component-plane layouts and the contiguous multi-device partitioning
all rely on.  The reference has no analog (PETSc natural ordering); this is
design, not translation.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from navierstokes_tpu.mesh.core import Mesh


def _adjacency_lists(nv: int, rows: np.ndarray, cols: np.ndarray):
    """CSR-style adjacency from symmetric COO (self-loops removed)."""
    mask = rows != cols
    r, c = rows[mask], cols[mask]
    order = np.argsort(r, kind="stable")
    r, c = r[order], c[order]
    ptr = np.zeros(nv + 1, dtype=np.int64)
    np.add.at(ptr, r + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, c


def rcm_ordering(mesh: Mesh) -> np.ndarray:
    """Reverse Cuthill–McKee permutation: perm[new] = old node index."""
    from navierstokes_tpu import native

    built = native.build_pattern_native(mesh.nv, mesh.tets)
    if built is not None:
        indptr, indices, _ = built
        perm = native.rcm_native(mesh.nv, indptr, indices)
        if perm is not None:
            return perm
    return _rcm_ordering_py(mesh)


def _rcm_ordering_py(mesh: Mesh) -> np.ndarray:
    rows, cols = mesh.node_adjacency()
    nv = mesh.nv
    ptr, adj = _adjacency_lists(nv, rows, cols)
    degree = np.diff(ptr)

    visited = np.zeros(nv, dtype=bool)
    order = []
    # Process all components; start each from a minimum-degree node.
    remaining = np.argsort(degree, kind="stable")
    rem_pos = 0
    while len(order) < nv:
        while rem_pos < len(remaining) and visited[remaining[rem_pos]]:
            rem_pos += 1
        start = remaining[rem_pos]
        visited[start] = True
        q = deque([start])
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = adj[ptr[u] : ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                q.extend(nbrs.tolist())
    return np.asarray(order[::-1], dtype=np.int32)


def reorder_mesh(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """Renumber nodes so new node i is old node perm[i]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return Mesh(
        coords=mesh.coords[perm],
        tets=inv[mesh.tets],
        node_tags=mesh.node_tags[perm],
    )


def best_ordering(mesh: Mesh) -> np.ndarray:
    """Pick the bandwidth-minimizing ordering among {natural, RCM}.

    Structured generator meshes are already numbered near-optimally; RCM wins
    on genuinely unstructured (Gmsh) meshes.
    """
    identity = np.arange(mesh.nv, dtype=np.int32)
    rcm = rcm_ordering(mesh)
    bw_nat = block_bandwidth(mesh)
    bw_rcm = block_bandwidth(reorder_mesh(mesh, rcm))
    return rcm if bw_rcm < bw_nat else identity


def block_bandwidth(mesh: Mesh) -> int:
    """Max |i - j| over adjacent node pairs — the block bandwidth of the operator."""
    rows, cols = mesh.node_adjacency()
    if len(rows) == 0:
        return 0
    return int(np.max(np.abs(rows.astype(np.int64) - cols.astype(np.int64))))
