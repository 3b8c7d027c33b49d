"""P1 tetrahedral element integration (the math core, L0 of SURVEY.md §1).

Re-derivation of the reference element matrices (`src/integration.c`) in
closed, batched form.  All functions here operate on ONE element with plain
`jnp` ops and are meant to be `vmap`-ed over the element axis; under `jit`
the batched versions become fused dense batched einsums — no Python loops,
no 12x12 scalar kernels.

DoF conventions (matching the reference):
  - local velocity DoF I = 3*i + alpha for node i in 0..3, component alpha,
  - the velocity field at nodes is `U[alpha, i]` (component-major, like the
    reference's `Uloc[3][4]`),
  - element matrices: M/A0/A1/A2 are 12x12, B is 4x12 (pressure x velocity),
    D is 4x4.

Parity cross-references: tet_volum `src/integration.c:7-15`; tet_gradients
`:19-67`; tet_diameter `:70-81`; mass `:84-109`; diffusion `:112-164`;
convection1 `:167-187`; convection2 `:190-209`; divergence `:212-221`;
pressure stabilization `:224-238`; exact convection Jacobian
`src/solve_newton.c:388-439`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Voigt weights for the symmetric-gradient contraction eps(u):C:eps(v)
# (the {1,1,1,0.5,0.5,0.5} diagonal of `src/integration.c:119`).
_VOIGT_WEIGHTS = (1.0, 1.0, 1.0, 0.5, 0.5, 0.5)

# Every contraction below runs at full precision: the default f32 matmul
# precision of an accelerator may be reduced (TF32 on the GPU, a 10-bit
# mantissa), which would round the assembled operator's entries.
_HP = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_HP)


def _einsum(spec, *operands):
    return jnp.einsum(spec, *operands, precision=_HP)


def tet_volume(a):
    """Signed volume det(a1-a0, a2-a0, a3-a0) / 6 for vertices a: (4, 3)."""
    e = a[1:] - a[0]  # (3, 3) rows e1, e2, e3
    det = (
        e[0, 0] * (e[1, 1] * e[2, 2] - e[1, 2] * e[2, 1])
        - e[0, 1] * (e[1, 0] * e[2, 2] - e[1, 2] * e[2, 0])
        + e[0, 2] * (e[1, 0] * e[2, 1] - e[1, 1] * e[2, 0])
    )
    return det / 6.0


def tet_gradients(a):
    """P1 shape-function gradients, (4, 3).

    grad_i = (outward normal of the face opposite node i) / 6V, built from the
    same fixed orientation-consistent vertex orderings as the reference so
    results agree to roundoff.
    """
    e = a[1:] - a[0]
    n = jnp.cross(e[1], e[2])
    vol6 = jnp.dot(e[0], n, precision=_HP)  # 6V

    # Opposite-face vertex triples (j, k, l) per node, orientation-fixed.
    faces = ((1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1))
    grads = []
    for j, k, l in faces:
        v1 = a[k] - a[j]
        v2 = a[l] - a[j]
        grads.append(jnp.cross(v1, v2) / vol6)
    return jnp.stack(grads)


def tet_diameter(a):
    """Longest edge length (element diameter h_K)."""
    diff = a[:, None, :] - a[None, :, :]  # (4, 4, 3)
    d2 = jnp.sum(diff * diff, axis=-1)
    return jnp.sqrt(jnp.max(d2))


def mass_matrix_scalar(vol, dtype=None):
    """Scalar P1 mass matrix M4 (4, 4): vol/10 diagonal, vol/20 off-diagonal."""
    dtype = dtype or jnp.result_type(vol)
    base = jnp.full((4, 4), 1.0 / 20.0, dtype=dtype) + jnp.eye(4, dtype=dtype) / 20.0
    return vol * base


def mass_matrix(vol, dtype=None):
    """Vector mass matrix (12, 12): M4 per velocity component, interleaved DoF."""
    m4 = mass_matrix_scalar(vol, dtype)
    # M[3i+a, 3j+b] = delta_ab * M4[i, j]
    eye3 = jnp.eye(3, dtype=m4.dtype)
    return _einsum("ij,ab->iajb", m4, eye3).reshape(12, 12)


def strain_operator(grad):
    """Voigt strain operator S (6, 12): S @ u_flat = voigt(eps(u)).

    Row order: [dx u1, dy u2, dz u3, dy u1 + dx u2, dz u1 + dx u3, dz u2 + dy u3]
    with u_flat[3j + c] the c-component at node j.
    """
    dtype = grad.dtype
    S = jnp.zeros((6, 4, 3), dtype=dtype)
    S = S.at[0, :, 0].set(grad[:, 0])
    S = S.at[1, :, 1].set(grad[:, 1])
    S = S.at[2, :, 2].set(grad[:, 2])
    S = S.at[3, :, 0].set(grad[:, 1])
    S = S.at[3, :, 1].set(grad[:, 0])
    S = S.at[4, :, 0].set(grad[:, 2])
    S = S.at[4, :, 2].set(grad[:, 0])
    S = S.at[5, :, 1].set(grad[:, 2])
    S = S.at[5, :, 2].set(grad[:, 1])
    return S.reshape(6, 12)


def diffusion_matrix(grad, vol, reynolds):
    """A0 (12, 12) = (2/Re) * vol * S^T diag(w) S  (viscous term)."""
    S = strain_operator(grad)
    w = jnp.asarray(_VOIGT_WEIGHTS, dtype=S.dtype)
    return (2.0 / reynolds) * vol * _mm(S.T * w, S)


def velocity_gradient(U, grad):
    """G[alpha, beta] = d u_alpha / d x_beta for nodal field U (3, 4)."""
    return _mm(U, grad)  # (3, 4) @ (4, 3) -> (3, 3)


def convection_matrix_linearized(U, grad, vol):
    """A1 (12, 12): A1[3i+a, 3j+b] = G[a, b] * M4[i, j]."""
    G = velocity_gradient(U, grad)
    m4 = mass_matrix_scalar(vol, G.dtype)
    return _einsum("ij,ab->iajb", m4, G).reshape(12, 12)


def convection_matrix_nonlinear(U, grad, vol):
    """A2 (12, 12): A2[3i+a, 3j+b] = -delta_ab * sum_m M4[i, m] (U[:, m] . grad_j)."""
    m4 = mass_matrix_scalar(vol, U.dtype)
    K = _einsum("dm,jd->mj", U, grad)          # (4, 4): K[m, j] = U[:,m].grad_j
    T = _mm(m4, K)                              # (4, 4)
    eye3 = jnp.eye(3, dtype=U.dtype)
    return -_einsum("ij,ab->iajb", T, eye3).reshape(12, 12)


def divergence_matrix(grad, vol):
    """B (4, 12): B[i, 3j+a] = (vol/4) * grad[j, a]  (independent of i)."""
    row = (vol / 4.0) * grad.reshape(12)
    return jnp.broadcast_to(row, (4, 12))


def pressure_stabilization_matrix(grad, vol, h, delta):
    """D (4, 4) = delta * h^2 * vol * grad_i . grad_j  (Brezzi–Pitkaranta)."""
    return (delta * h * h * vol) * _mm(grad, grad.T)


def convection_jacobian(U, grad, vol):
    """Exact Jacobian of the convection terms, (A1_jac, A2_jac), each (12, 12).

    A1_jac[3i+a, 3k+b] = (vol/4) * G[a, b]              (independent of i, k)
    A2_jac[3i+a, 3k+b] = delta_ab * (vol/4) * (u_mean . grad_k)
    """
    dtype = U.dtype
    G = velocity_gradient(U, grad)
    q = vol / 4.0
    ones4 = jnp.ones((4, 4), dtype=dtype)
    A1_jac = q * _einsum("ik,ab->iakb", ones4, G).reshape(12, 12)

    u_mean = jnp.mean(U, axis=1)                  # (3,)
    c = _mm(grad, u_mean)                         # (4,): u_mean . grad_k
    eye3 = jnp.eye(3, dtype=dtype)
    A2_jac = q * _einsum("i,k,ab->iakb", jnp.ones(4, dtype=dtype), c, eye3).reshape(
        12, 12
    )
    return A1_jac, A2_jac


# ---------------------------------------------------------------------------
# Per-element geometric precompute (the `ElementMatrices` analog,
# `src/solve_newton.c:26-36`): only the cheap invariants are stored; matrices
# are rebuilt on the fly under jit (recompute beats memory traffic).
# ---------------------------------------------------------------------------


def element_geometry(a):
    """(vol, grad, h) for one element; vmap over the leading axis for batches."""
    return tet_volume(a), tet_gradients(a), tet_diameter(a)


batched_geometry = jax.vmap(element_geometry)


def element_node_blocks(grad, vol, h, UL, dt, reynolds, delta, *, terms):
    """The (4, 4, 4, 4) array of per-node-pair 4x4 blocks for ONE element.

    blocks[i, j] is the 4x4 block coupling node i (rows) and node j (cols):
      [ vel-vel (3x3) | B^T col ]      vel-vel  = selected terms below
      [ -B row        | D[i, j] ]      B^T col  = (vol/4) grad[i, a]
                                        B row    = (vol/4) grad[j, b]

    `terms` is a frozenset subset of {"mass_dt", "diffusion", "convection",
    "convection_jacobian"}:
      - Stokes operator      : {"diffusion"}                (`src/solve_newton.c:617-662`)
      - J_linear             : {"mass_dt", "diffusion"}     (`:520-563`)
      - full Newton Jacobian : all four                     (`:448-517`)
      - nonlinear increment  : {"convection", "convection_jacobian"} with the
        caller responsible for zeroing B/D (see `add_nonlinear_jacobian_terms`
        `:566-615`, which leaves B/D at zero).
    """
    dtype = grad.dtype
    vv = jnp.zeros((12, 12), dtype=dtype)
    if "diffusion" in terms:
        vv = vv + diffusion_matrix(grad, vol, reynolds)
    if "mass_dt" in terms or "mass_dt_bare" in terms:
        # "mass_dt_bare": the velocity-mass operator alone (no B/B^T/D
        # blocks) — used for the operator-form residual's M/dt u_old term.
        vv = vv + mass_matrix(vol, dtype) / dt
    if "convection" in terms:
        vv = vv + convection_matrix_linearized(UL, grad, vol)
        vv = vv + convection_matrix_nonlinear(UL, grad, vol)
    if "convection_jacobian" in terms:
        a1j, a2j = convection_jacobian(UL, grad, vol)
        vv = vv + a1j + a2j

    vv4 = vv.reshape(4, 3, 4, 3).transpose(0, 2, 1, 3)  # (i, j, a, b)

    blocks = jnp.zeros((4, 4, 4, 4), dtype=dtype)
    blocks = blocks.at[:, :, :3, :3].set(vv4)

    include_linear = ("diffusion" in terms) or ("mass_dt" in terms)
    if include_linear:
        bt = (vol / 4.0) * grad  # (i, a): B^T entry for row (i,a), any col node j
        blocks = blocks.at[:, :, :3, 3].set(
            jnp.broadcast_to(bt[:, None, :], (4, 4, 3))
        )
        blocks = blocks.at[:, :, 3, :3].set(
            jnp.broadcast_to(-bt[None, :, :], (4, 4, 3))
        )
        D = pressure_stabilization_matrix(grad, vol, h, delta)
        blocks = blocks.at[:, :, 3, 3].set(D)
    return blocks


def element_residual(grad, vol, h, UL, UL_old, PL, dt, reynolds, delta):
    """Per-element residual contributions (F_v (4,3) by node/component, F_p (4,)).

    F_v = (A0 + M/dt) u + (A1 + A2) u - (M/dt) u_old + B^T p
    F_p = -B u + D p
    (`compute_residual_optimized`, `src/solve_newton.c:284-386`), computed by
    direct contraction without materializing 12x12 matrices.
    """
    dtype = grad.dtype
    m4 = mass_matrix_scalar(vol, dtype)

    # M/dt terms, per component: (M4 @ U^T) / dt -> (4 nodes, 3 comps)
    mass_term = _mm(m4, (UL - UL_old).T) / dt

    # Diffusion: F_v[i, c] = (2/Re) vol sum_b grad[i, b] tau[c, b]
    G = velocity_gradient(UL, grad)               # (3, 3)
    sym = 0.5 * (G + G.T)
    # tau = weighted stress: diagonal weight 1, off-diagonal weight 0.5 applied
    # to (G + G^T) -> exactly S^T diag(w) S u expanded.
    tau = jnp.where(jnp.eye(3, dtype=bool), G, sym)
    diff_term = (2.0 / reynolds) * vol * _mm(grad, tau.T)  # (4, 3)

    # Convection A1: (A1 u)[i, a] = sum_j M4[i, j] sum_b G[a, b] U[b, j]
    conv1 = _mm(m4, _mm(G, UL).T)                  # (4, 3)
    # Convection A2: (A2 u)[i, a] = -sum_j (sum_m M4[i, m] K[m, j]) U[a, j]
    K = _einsum("dm,jd->mj", UL, grad)
    conv2 = -_mm(_mm(m4, K), UL.T)                 # (4, 3)

    # Pressure gradient: (B^T p)[i, a] = (vol/4) grad[i, a] * sum_j p_j
    pgrad = (vol / 4.0) * jnp.sum(PL) * grad       # (4, 3)

    F_v = mass_term + diff_term + conv1 + conv2 + pgrad

    # Divergence: (B u)[i] = (vol/4) sum_{j,a} grad[j, a] U[a, j]  (indep of i)
    div = (vol / 4.0) * jnp.sum(grad * UL.T)
    D = pressure_stabilization_matrix(grad, vol, h, delta)
    F_p = -div * jnp.ones(4, dtype=dtype) + _mm(D, PL)
    return F_v, F_p
