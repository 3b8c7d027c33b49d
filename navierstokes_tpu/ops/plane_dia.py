"""Component-plane DIA SpMV — the block-structure-aware operator layout.

The answer to the reference's "does a second block layout pay?" question
(`src/kernels/baij8_avx512.c` tried 8x8 blocks for AVX-512 register reuse).
The SpMV is a bandwidth-bound stream, so a layout wins exactly when it
moves fewer bytes while staying gather-free.  The census over the real
patterns (`bench/layout_census.py`) shows the scalar-DIA band stores 81
scalar diagonals where the underlying BLOCK pattern has only 15 node
diagonals: dense 4x4 blocks on 15 node offsets need 15*16 = 240 nb values,
0.741x of scalar-DIA's 81*4 nb = 324 nb.

The layout change that unlocks it is the reference's OWN alternative DoF
numbering: ORDER_BY_COMPONENT (`src/create_mat.c:55-61`).  With vectors
stored as four contiguous component planes (u | v | w | p, each (nbp,)),
the operator becomes 16 plane-pair couplings, each a band of 15 node
diagonals over (nbp,)-vectors:

    y_a[i] = sum_{b, D}  V[a, b, D][i] * x_b[i + D]

— statically shifted contiguous slices, zero gathers.  Operator data is
stored naturally as (n_out, NT, nbp): plane a, term j = (b, D) of
`plane_terms`, node i.  `spmv_planes` is plain `jax.numpy`: XLA fuses the
shifted slices, the multiplies and the sum into one loop fusion, and the
x reuse across the +-h window is served by the caches.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def node_offsets_from_scalar(offsets: tuple) -> tuple:
    """Block (node) offsets D from the scalar-DIA offset set.

    A real 4x4 block at node offset D always populates scalar diagonal 4D
    (its (a, a) entries), and 4D is in the scalar set ONLY via a real block
    offset (4D' + e = 4D forces e = 4(D - D') in [-3, 3] => D' = D).  The
    coverage assert guarantees every scalar diagonal is reachable from some
    block offset (true for dense node blocks — the FEM pattern's case).
    """
    ks = set(offsets)
    cands = tuple(sorted(d for d in range(min(offsets) // 4 - 1,
                                          max(offsets) // 4 + 2)
                         if 4 * d in ks))
    cover = {4 * d + e for d in cands for e in range(-3, 4)}
    missing = ks - cover
    if missing:
        raise ValueError(f"scalar diagonals {sorted(missing)} not covered "
                         "by any node offset (non-dense blocks?)")
    return cands


def plane_terms(node_offsets: tuple, n_in: int = 4) -> tuple:
    """Static term list [(b, D), ...] shared by all output planes."""
    return tuple((b, d) for d in node_offsets for b in range(n_in))


def plane_halo(node_offsets: tuple) -> int:
    """Node halo h = max |D| (at least 1): the x window each node reads."""
    return max(max(abs(d) for d in node_offsets), 1)


def extract_planes(offsets: tuple, data, nb: int, node_offsets=None,
                   nbp: int = None):
    """Scalar-DIA (K, 4*nb) data -> plane data (4, NT, nbp).

    planes[a, j] with terms[j] = (b, D) holds A[4i+a, 4(i+D)+b] for each
    node row i — i.e. the (a, b) entries of the node-offset-D blocks.
    Entry k = 4D + (b - a) of the scalar set; rows 4i + a are the stride-4
    slice data[k][a::4].  Scalar diagonals absent from the set are zero
    planes (blocks the band union padded in; they carry no values).  Nodes
    nb..nbp are zero padding (`nbp` defaults to nb).
    """
    if node_offsets is None:
        node_offsets = node_offsets_from_scalar(offsets)
    terms = plane_terms(node_offsets)
    kidx = {k: i for i, k in enumerate(offsets)}
    zeros = jnp.zeros((nb,), data.dtype)
    planes = []
    for a in range(4):
        rows = []
        for b, d in terms:
            k = 4 * d + (b - a)
            if k in kidx:
                rows.append(jax.lax.slice_in_dim(data[kidx[k]], a, 4 * nb, 4))
            else:
                rows.append(zeros)
        planes.append(jnp.stack(rows))
    planes = jnp.stack(planes)                       # (4, NT, nb)
    if nbp is not None and nbp > nb:
        planes = jnp.pad(planes, ((0, 0), (0, 0), (0, nbp - nb)))
    return planes


@functools.partial(jax.jit, static_argnames=("node_offsets", "x_prehalo"))
def spmv_planes(node_offsets, data, x, *, x_prehalo: bool = False):
    """y = A x for an (n_out x n_in) plane-coupling operator.

    data: (n_out, NT, nbp) plane couplings, term order `plane_terms
    (node_offsets, n_in)` with n_in = NT / len(node_offsets); x: flat
    plane-major (n_in * nbp,); returns (n_out * nbp,).  The full node-block
    operator is 4x4; sub-block applies ride the same function — the
    velocity block F (3x3), the divergence row -B (1x3), the gradient
    column B^T (3x1) and scalar node operators such as the approximate
    pressure Schur complement (1x1, solvers/schur.py) — paying memory
    traffic only for the planes they touch.

    Rows whose data columns are zero (padding nodes) come out zero.
    x_prehalo=True: each plane of x already carries `h` ghost nodes on both
    ends, x is (n_in * (nbp + 2h),) — the distributed per-shard case, halo
    filled by a ppermute exchange (parallel.partitioned_spmv_plane).
    """
    n_out, nt, nbp = data.shape
    n_in = nt // len(node_offsets)
    terms = plane_terms(node_offsets, n_in)
    assert nt == len(terms), (nt, len(terms))
    h = plane_halo(node_offsets)
    if x_prehalo:
        assert x.shape[0] == n_in * (nbp + 2 * h), (x.shape, n_in, nbp, h)
        xw = x.reshape(n_in, nbp + 2 * h)
    else:
        assert x.shape[0] == n_in * nbp, (x.shape, n_in, nbp)
        xw = jnp.pad(x.reshape(n_in, nbp), ((0, 0), (h, h)))
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)
    acc = jnp.zeros((n_out, nbp), acc_dtype)
    for j, (b, d) in enumerate(terms):
        xs = jax.lax.slice_in_dim(xw[b], h + d, h + d + nbp)
        acc = acc + data[:, j, :].astype(acc_dtype) * xs.astype(acc_dtype)
    return acc.astype(x.dtype).reshape(-1)


def to_planes(x, nb: int, nbp: int):
    """Interleaved (4*nb,) -> flat plane-major (4*nbp,) (zero-padded)."""
    p = x.reshape(nb, 4).T
    return jnp.pad(p, ((0, 0), (0, nbp - nb))).reshape(-1)


def from_planes(xp, nb: int, nbp: int):
    """Flat plane-major (4*nbp,) -> interleaved (4*nb,)."""
    return xp.reshape(4, nbp)[:, :nb].T.reshape(-1)
