"""Blocked sparse matrix-vector products (the #9-11 / #24 kernel family).

Variants, ordered from oracle to fast:

- `spmv_bcsr_ref`: segment-sum over BCSR blocks — the "scalar CSR" oracle
  every optimized variant is validated against, mirroring the reference's
  methodology (`mpk/SpMV.cpp:7-20` + `rel_error`, `mpk/utils.cpp:131-143`).
- `spmv_bell`: gather + batched einsum over the padded block-ELL layout; XLA
  lowers the gather and fuses the 4x4 contraction.
- `spmv_bell_windowed`: same contraction but with columns rebased into a
  per-row-tile window (valid under RCM ordering).
- `spmv_dia`: the scalar-DIA shifted multiply-adds (`sparse/dia.py`).

All inputs use scalar DoF vectors x of shape (4*nb,).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Full f32 contractions: the default matmul precision may be reduced on an
# accelerator (TF32 on the GPU).
HP = jax.lax.Precision.HIGHEST


def spmv_bcsr_ref(row_ids, indices, values, x):
    """Oracle SpMV. row_ids/indices: (nnzb,), values: (nnzb,4,4), x: (4nb,)."""
    nb = x.shape[0] // 4
    x4 = x.reshape(nb, 4)
    contrib = jnp.einsum("kab,kb->ka", values, x4[indices], precision=HP)
    y4 = jax.ops.segment_sum(contrib, row_ids, num_segments=nb)
    return y4.reshape(-1)


def spmv_bell(indices, values, x):
    """Block-ELL SpMV: y[r] = sum_s values[r, s] @ x4[indices[r, s]].

    indices: (nb, S) int32, values: (nb, S, 4, 4), x: (4nb,).
    """
    nb, s = indices.shape
    x4 = x.reshape(nb, 4)
    gathered = x4[indices]                        # (nb, S, 4)
    y4 = jnp.einsum("rsab,rsb->ra", values, gathered, precision=HP)
    return y4.reshape(-1)


def spmv_bell_multi(indices, values, X):
    """Block-ELL SpMM against a multivector X: (4nb, m) -> (4nb, m).

    The s-step Krylov basis building block (`MatMatMult_SeqBAIJ_4_AVX2`,
    `src/kernels/spmm_avx2.c:7-109`) — just a wider einsum, an (a x b) @
    (b x m) contraction per block.
    """
    nb, s = indices.shape
    m = X.shape[1]
    X4 = X.reshape(nb, 4, m)
    gathered = X4[indices]                        # (nb, S, 4, m)
    Y4 = jnp.einsum("rsab,rsbm->ram", values, gathered, precision=HP)
    return Y4.reshape(4 * nb, m)


def spmv_bell_windowed(indices, values, x, *, tile, window_starts, window):
    """Row-tiled SpMV with windowed x access.

    For each tile t of `tile` block-rows, all referenced columns must lie in
    [window_starts[t], window_starts[t] + window).  Columns are rebased into
    the window and gathered from the local slice.
    """
    nb, s = indices.shape
    assert nb % tile == 0
    nt = nb // tile
    x4 = x.reshape(nb, 4)

    def tile_body(t):
        w0 = window_starts[t]
        zero = jnp.zeros((), w0.dtype)
        t0 = (t * tile).astype(w0.dtype)
        xw = jax.lax.dynamic_slice(x4, (w0, zero), (window, 4))   # (W, 4)
        idx = jax.lax.dynamic_slice(indices, (t0, zero), (tile, s)) - w0
        vals = jax.lax.dynamic_slice(
            values, (t0, zero, zero, zero), (tile, s, 4, 4)
        )
        gathered = xw[idx]                                      # (tile, S, 4)
        return jnp.einsum("rsab,rsb->ra", vals, gathered, precision=HP)

    y4 = jax.vmap(tile_body)(jnp.arange(nt))
    return y4.reshape(-1)


def spmv_dia(offsets, data, x):
    """Scalar-DIA SpMV: y = sum_k data[k] * shift(x, offsets[k]).

    The scalar fast path (see `sparse/dia.py`): K unrolled fused
    multiply-adds over contiguous (ndof,) vectors, statically shifted
    slices, zero gathers; memory-bandwidth-bound.

    offsets: static tuple of ints; data: (K, ndof); x: (ndof,).
    """
    n = x.shape[0]
    h = max(max(abs(d) for d in offsets), 1)
    xp = jnp.pad(x, (h, h))
    y = jnp.zeros(n, jnp.result_type(data.dtype, x.dtype))
    for k, d in enumerate(offsets):
        y = y + data[k] * jax.lax.dynamic_slice(xp, (h + d,), (n,))
    return y


def spmv_dia_multi(offsets, data, X):
    """DIA SpMM against a multivector X: (ndof, m) -> (ndof, m)."""
    n, m = X.shape
    h = max(max(abs(d) for d in offsets), 1)
    Xp = jnp.pad(X, ((h, h), (0, 0)))
    Y = jnp.zeros((n, m), jnp.result_type(data.dtype, X.dtype))
    for k, d in enumerate(offsets):
        Y = Y + data[k][:, None] * jax.lax.dynamic_slice(Xp, (h + d, 0), (n, m))
    return Y


SPMV_VARIANTS = ("oracle", "ell", "dia", "dia_bf16", "plane")


def make_spmv(variant: str, *, bcsr=None, ell=None, dia=None):
    """Runtime SpMV variant dispatch — the `MatMult_SeqBAIJ_4_VariantSelector`
    equivalent (`src/kernels/variant_selector.c:3-15`), selected by name
    instead of a PETSc option.  Pass whichever format objects the variant
    needs; returns a closure y = A x.
    """
    if variant == "oracle":
        import jax.numpy as _jnp

        row_ids = _jnp.asarray(bcsr.row_ids())
        idx = _jnp.asarray(bcsr.indices)
        return lambda x: spmv_bcsr_ref(row_ids, idx, bcsr.values, x)
    if variant == "ell":
        import jax.numpy as _jnp

        idx = _jnp.asarray(ell.indices)
        return lambda x: spmv_bell(idx, ell.values, x)
    if variant == "dia":
        return lambda x: spmv_dia(dia.offsets, dia.data, x)
    if variant == "dia_bf16":
        data16 = dia.data.astype(jnp.bfloat16)
        return lambda x: spmv_dia(dia.offsets, data16, x).astype(x.dtype)
    if variant == "plane":
        from navierstokes_tpu.ops.plane_dia import (
            extract_planes,
            from_planes,
            node_offsets_from_scalar,
            spmv_planes,
            to_planes,
        )

        nb = dia.ndof // 4
        noffs = node_offsets_from_scalar(dia.offsets)
        planes = extract_planes(dia.offsets, dia.data, nb, node_offsets=noffs)
        return lambda x: from_planes(
            spmv_planes(noffs, planes, to_planes(x, nb, nb)), nb, nb)
    raise ValueError(f"unknown spmv variant {variant!r}; one of {SPMV_VARIANTS}")


def compute_window_starts(indices, tile, window):
    """Host-side: per-tile window start so all tile columns fit in `window`."""
    import numpy as np

    nb, _ = indices.shape
    nt = nb // tile
    starts = np.empty(nt, dtype=np.int32)
    for t in range(nt):
        cmin = int(indices[t * tile : (t + 1) * tile].min())
        cmax = int(indices[t * tile : (t + 1) * tile].max())
        if cmax - cmin + 1 > window:
            raise ValueError(
                f"tile {t}: column span {cmax - cmin + 1} exceeds window {window}"
            )
        starts[t] = min(max(cmin, 0), nb - window)
    return starts
