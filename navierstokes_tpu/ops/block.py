"""Small dense block operations.

The 4x4 unpivoted Gauss–Jordan inverse is the batched equivalent of
`Kernel_A_gets_inverse_A_4_nopivot_scalar` (`src/kernels/baij4_factor_avx2.c:7-58`)
with the same zero-pivot emergency regularization (+1e-8 on the diagonal,
`:283-290`), vmapped into one batched op for the block-Jacobi preconditioner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _inv4_one(a, pivot_eps, shift):
    """Unpivoted Gauss-Jordan inverse of one 4x4 with zero-pivot shift."""

    def body(k, aug):
        pivot = aug[k, k]
        bad = jnp.abs(pivot) < pivot_eps
        pivot = jnp.where(bad, pivot + shift, pivot)
        row = aug[k] / pivot
        aug = aug.at[k].set(row)
        factors = aug[:, k].at[k].set(0.0)
        return aug - factors[:, None] * row[None, :]

    aug = jnp.concatenate([a, jnp.eye(4, dtype=a.dtype)], axis=1)
    aug = jax.lax.fori_loop(0, 4, body, aug)
    return aug[:, 4:]


def block4_inverse(blocks, pivot_eps=0.0, shift=1e-8):
    """Batched inverse of (..., 4, 4) blocks via unpivoted Gauss-Jordan.

    pivot_eps=0.0 disables the emergency shift (exact inverse path); set
    pivot_eps>0 to regularize near-singular pivots like the reference does.
    """
    flat = blocks.reshape(-1, 4, 4)
    inv = jax.vmap(lambda b: _inv4_one(b, pivot_eps, shift))(flat)
    return inv.reshape(blocks.shape)


def block4_apply(blocks, x):
    """y = blockdiag(blocks) @ x for blocks (nb, 4, 4), x (4nb,)."""
    nb = blocks.shape[0]
    return jnp.einsum("rab,rb->ra", blocks, x.reshape(nb, 4),
                      precision=jax.lax.Precision.HIGHEST).reshape(-1)
