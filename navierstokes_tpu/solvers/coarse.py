"""Two-level (coarse-grid corrected) preconditioning.

Block-Jacobi kills only local error; the global (low-frequency) error on a
121k-DoF channel makes GMRES iterate hundreds of times.  The classic cure is
a coarse space: aggregate nodes (contiguous index ranges — spatially local
after band ordering), build the Galerkin coarse operator A_c = R A P with
piecewise-constant-per-component prolongation, invert it DENSELY once (a few
thousand DoF — one small dense matmul per apply), and combine
multiplicatively with block-Jacobi:

    z  = P A_c^{-1} R r                      (coarse correction)
    z += D^{-1} (r - A z)                    (local smoothing)

This is an accelerator-friendly replacement for the reference's ILU(k)
strength: the sequential triangular solves become one dense (nc x nc) matvec +
one SpMV, both batched/regular. No analog exists in the reference (single-level
ILU).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class CoarseSpace:
    """Static aggregation data (host + device).

    Aggregates are CONTIGUOUS equal-size index ranges (band-ordered mesh =>
    spatial blocks), so restriction/prolongation are pure reshape-reduce /
    broadcast — no gathers or segment sums on the hot path.
    """

    agg_of_node: np.ndarray      # (nb,) aggregate id per node
    n_agg: int
    agg_size: int
    nb: int
    agg_dev: jnp.ndarray         # device copy (for the Galerkin scatter)

    @property
    def nc(self) -> int:
        return 4 * self.n_agg

    @property
    def nb_pad(self) -> int:
        return self.n_agg * self.agg_size


def build_aggregates(nb: int, agg_size: int = 64) -> CoarseSpace:
    agg = (np.arange(nb) // agg_size).astype(np.int32)
    return CoarseSpace(
        agg_of_node=agg,
        n_agg=int(agg[-1]) + 1 if nb else 0,
        agg_size=agg_size,
        nb=nb,
        agg_dev=jnp.asarray(agg),
    )


def _mix_matrix(agg: int, dtype):
    """(4*agg, 4) 0/1 matrix: column c picks the stride-4 residue c.

    Lets restrict/prolong run as (n_agg, 4*agg) matmuls on FLAT lane-major
    data.  The naive reshape formulation creates (nb, 4)/(n_agg, agg, 4)
    intermediates whose minor dim XLA tile-pads (8, 128) -> 32x HBM
    inflation; inside the triple-nested solver loops that inflation
    multiplied across ~130 live loop temps and hit 37 GB of HLO temp at
    2.35M rows (compile-time OOM).  Here the only 4-minor array is the
    (n_agg, 4) coarse product — coarse-sized, negligible."""
    m = np.zeros((4 * agg, 4), dtype)
    m[np.arange(4 * agg), np.arange(4 * agg) % 4] = 1.0
    return jnp.asarray(m)


def restrict(cs: CoarseSpace, r):
    """R r: per-component sum over each aggregate. (4*nb,) -> (nc,).

    precision=HIGHEST is load-bearing: a reduced default matmul precision
    (TF32 on the GPU, bf16 passes elsewhere) truncates the residual values
    BEFORE the aggregate sums, and the damaged coarse correction costs
    linear iterations and Newton iterations per step (181 vs 69 linear
    iterations at m6 with bf16 operand rounding).  These are
    bandwidth-bound tall-skinny GEMVs; exact f32 passes are free."""
    r2 = jnp.pad(r, (0, 4 * (cs.nb_pad - cs.nb))).reshape(
        cs.n_agg, 4 * cs.agg_size
    )
    return jnp.matmul(
        r2, _mix_matrix(cs.agg_size, r.dtype),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1)


def prolong(cs: CoarseSpace, rc):
    """P rc = R^T rc: inject aggregate values back. (nc,) -> (4*nb,).

    precision=HIGHEST for the same reason as `restrict` (bf16 operand
    rounding would truncate the coarse correction to 8 mantissa bits)."""
    out = jnp.matmul(
        rc.reshape(cs.n_agg, 4), _mix_matrix(cs.agg_size, rc.dtype).T,
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(-1)[: 4 * cs.nb]


def restrict_planes(cs: CoarseSpace, rp, nbp: int):
    """R r on a plane-major padded fine vector -> interleaved coarse (nc,).

    Plane layout makes restriction a pure reshape-sum per plane; the
    component-interleave happens on the COARSE vector (nc <= ~16k), where a
    transpose costs nothing — this replaces two O(n) fine-vector layout
    conversions per preconditioner apply."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    r2 = rp.reshape(4, nbp)[:, :cs.nb_pad]
    # (rows past nb are zero by construction throughout the plane solve)
    rc = r2.reshape(4, cs.n_agg, cs.agg_size).sum(-1)     # (4, n_agg)
    return rc.T.reshape(-1)                               # interleaved (nc,)


def prolong_planes(cs: CoarseSpace, zc, nbp: int, nb: int, dtype=None):
    """P zc: interleaved coarse (nc,) -> plane-major padded fine vector."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    z2 = zc.reshape(cs.n_agg, 4).T                        # (4, n_agg)
    zf = jnp.broadcast_to(
        z2[:, :, None], (4, cs.n_agg, cs.agg_size)
    ).reshape(4, cs.nb_pad)
    zf = jnp.pad(zf, ((0, 0), (0, nbp - cs.nb_pad)))
    # zero the kernel-padding rows (nb..nbp) the broadcast just filled
    mask = (jnp.arange(nbp) < nb)[None, :]
    return jnp.where(mask, zf, jnp.zeros((), zf.dtype)).reshape(-1)


def coarse_dia_offsets(offsets: tuple, agg: int) -> tuple:
    """Static coarse-level DIA offsets produced by contiguous aggregation.

    The scalar index map ic = 4*((i//4)//agg) + i%4 is exactly periodic in i
    with period L = 4*agg (shifting i by L shifts ic by 4), so enumerating
    one interior period yields every offset jc - ic a valid fine entry can
    produce; boundary rows are residue classes of the same period.
    """
    L = 4 * agg
    h = max(abs(d) for d in offsets)
    base = (h // L + 1) * L                    # interior: j = i + d >= 0
    out = set()
    for r in range(L):
        i = base + r
        ic = 4 * ((i // 4) // agg) + i % 4
        for d in offsets:
            j = i + d
            jc = 4 * ((j // 4) // agg) + j % 4
            out.add(jc - ic)
    return tuple(sorted(out))


def coarse_operator_dia(
    cs: CoarseSpace, offsets: tuple, data, coarse_offsets: tuple,
    *, shift: float = 0.0
):
    """Sparse Galerkin coarse operator A_c = R A P in scalar-DIA form.

    The scalable alternative to `coarse_operator_inverse_dia` when nc is too
    large to invert densely: contiguous aggregation of a banded operator is
    itself banded, with Kc = len(coarse_offsets) diagonals.  One (ndof,)
    scatter per fine diagonal (jittable; pattern static)."""
    K, ndof = data.shape
    nc = cs.nc
    agg = cs.agg_size
    kc_n = len(coarse_offsets)
    co = jnp.asarray(coarse_offsets)
    i = jnp.arange(ndof)
    ic = 4 * ((i // 4) // agg) + (i % 4)
    flat = jnp.zeros(kc_n * nc, dtype=data.dtype)
    for k, d in enumerate(offsets):
        j = i + d
        valid = (j >= 0) & (j < ndof)
        j_cl = jnp.clip(j, 0, ndof - 1)
        jc = 4 * ((j_cl // 4) // agg) + (j_cl % 4)
        kc = jnp.searchsorted(co, jc - ic)
        # invalid entries contribute 0 wherever their (clipped) slot lands
        flat = flat.at[kc * nc + ic].add(jnp.where(valid, data[k], 0.0))
    ac = flat.reshape(kc_n, nc)
    if shift:
        k0 = coarse_offsets.index(0)
        ac = ac.at[k0].add(shift)
    return ac


def coarse_dense_matrix(
    cs: CoarseSpace, offsets: tuple, data, *, shift: float = 0.0
):
    """Dense A_c = R A P built from scalar-DIA data (jittable).

    One (ndof,)-sized scatter per diagonal — the scalable path (no
    block-form arrays)."""
    K, ndof = data.shape
    nc = cs.nc
    agg = cs.agg_size
    i = jnp.arange(ndof)
    ic = 4 * ((i // 4) // agg) + (i % 4)
    ac_flat = jnp.zeros(nc * nc, dtype=data.dtype)
    for k, d in enumerate(offsets):
        j = i + d
        valid = (j >= 0) & (j < ndof)
        j_cl = jnp.clip(j, 0, ndof - 1)
        jc = 4 * ((j_cl // 4) // agg) + (j_cl % 4)
        ac_flat = ac_flat.at[ic * nc + jc].add(
            jnp.where(valid, data[k], 0.0)
        )
    ac = ac_flat.reshape(nc, nc)
    if shift:
        ac = ac + shift * jnp.eye(nc, dtype=ac.dtype)
    return ac


def coarse_operator_inverse_dia(
    cs: CoarseSpace, offsets: tuple, data, *, shift: float = 0.0
):
    """Dense inverse of A_c = R A P built from scalar-DIA data.

    Whenever `data` is concrete (the prep runs eagerly — the default since
    the eager-stokes restructure), the inverse is computed on the HOST in
    f64, for two reasons:
      * accuracy: the saddle-point coarse matrix is ill-conditioned and an
        on-device f32 LU inverse carries O(cond * eps_f32) error — at m6
        (nc=2448) separately compiled preps produced inverses differing by
        ~0.26%, and GMRES counts of 182 vs 69 iters/step for the SAME
        system;
      * memory: an on-device LU inverse pipeline materializes blocked
        triangular-solve temps of many GB at nc ~ 10^4.
    Under jit there is no host escape on this backend (no pure_callback), so
    traced calls fall back to the on-chip f32 inverse."""
    ac = coarse_dense_matrix(cs, offsets, data, shift=shift)
    try:
        ac_host = np.asarray(ac, dtype=np.float64)
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError):
        # NB: TracerArrayConversionError is NOT a subclass of
        # ConcretizationTypeError; np.asarray on a tracer raises the
        # former (verified on this jax version)
        ac_host = None
    if ac_host is not None:
        return jnp.asarray(np.linalg.inv(ac_host), dtype=ac.dtype)
    return jnp.linalg.inv(ac)


def _agg_diag_add(ac_flat, v, node_off, a, c, n_agg, agg, nc, dof=4):
    """Accumulate row-wise contributions into the dense coarse matrix.

    `v[i]` (i a node index, length n_agg*agg, padding rows zero) contributes
    to A_c[dof*(i//agg) + a, dof*((i+node_off)//agg) + c] with a, c
    within-aggregate coarse-dof indices (dof = 4 for the piecewise-constant
    basis, 16 for the linear basis: 4 modes x 4 components).  For fixed
    node_off, (i+node_off)//agg = i//agg + q with q taking exactly two
    values split by the phase p = i%agg (p < t -> q0, p >= t -> q0+1), so
    each (q, a, c) lands on one dense diagonal of stride dof*(nc+1) — two
    vectorized strided adds replace a scatter."""
    q0, dm = divmod(int(node_off), agg)
    t = agg - dm
    V = v.reshape(n_agg, agg)
    ic = np.arange(n_agg)
    for q, s in ((q0, V[:, :t].sum(1, dtype=np.float64)),
                 (q0 + 1, V[:, t:].sum(1, dtype=np.float64) if dm else None)):
        if s is None:
            continue
        sel = (ic + q >= 0) & (ic + q < n_agg)
        idx = (dof * ic[sel] + a) * nc + dof * (ic[sel] + q) + c
        ac_flat[idx] += s[sel]


def _node_block_view(offsets: tuple, dd: np.ndarray, nb: int,
                     node_offsets: tuple) -> np.ndarray:
    """(N_D, nb, 4, 4) block view of the scalar-DIA band:
    A_blk[iD, i, a, b] = A[4i+a, 4(i+D)+b] (absent scalar diagonals are
    zero planes; out-of-range rows masked — DIA storage does not guarantee
    zeros there, the SpMV masks via x padding)."""
    kidx = {k: i for i, k in enumerate(offsets)}
    n_d = len(node_offsets)
    A_blk = np.zeros((n_d, nb, 4, 4), dtype=dd.dtype)
    for iD, D in enumerate(node_offsets):
        for a in range(4):
            for b in range(4):
                k = 4 * D + (b - a)
                if k in kidx:
                    A_blk[iD, :, a, b] = dd[kidx[k], a::4]
        if D < 0:
            A_blk[iD, :-D] = 0.0
        elif D > 0:
            A_blk[iD, nb - D:] = 0.0
    return A_blk


def build_linear_weights(cs: CoarseSpace, coords: np.ndarray) -> np.ndarray:
    """(4, nb_pad) per-aggregate orthonormal LINEAR basis weight planes.

    Mode m's weight on node i is Q[i//agg][i%agg, m], where Q is the
    per-aggregate QR-orthonormalization of [1, x - x_bar, y - y_bar,
    z - z_bar] over the aggregate's nodes (coords in OPERATOR row order —
    the mesh is band-reordered before discretization).  Spanning linear
    functions per aggregate approximates smooth error to O(h_agg^2) instead
    of the piecewise-constant basis's O(h_agg), attacking the measured
    coarse-space thinning at scale (69 -> 117 -> 253 lin iters/step over
    117k/511k/2.35M rows at fixed nc):
    with 4 modes per aggregate, 4x-larger aggregates give the SAME dense
    nc with a richer space.  Padding rows (>= nb) and rank-deficient modes
    (degenerate aggregate geometry) carry zero weight; the Galerkin
    builder pins their coarse diagonal so the dense inverse exists and the
    inert dofs contribute exactly zero correction."""
    nb, agg, n_agg, nb_pad = cs.nb, cs.agg_size, cs.n_agg, cs.nb_pad
    M = np.zeros((nb_pad, 4))
    M[:nb, 0] = 1.0
    M[:nb, 1:] = np.asarray(coords, dtype=np.float64)[:nb]
    M = M.reshape(n_agg, agg, 4)
    cnt = np.maximum(M[:, :, 0].sum(1), 1.0)
    for d in range(1, 4):
        mean = M[:, :, d].sum(1) / cnt
        M[:, :, d] -= mean[:, None]
        M[:, :, d] *= M[:, :, 0]           # re-zero padding rows
    Q, R = np.linalg.qr(M)          # batched reduced: k = min(agg, 4) cols
    rd = np.abs(np.diagonal(R, axis1=1, axis2=2))  # (n_agg, k)
    bad = rd < 1e-10 * np.maximum(rd.max(1, keepdims=True), 1e-300)
    Q = np.where(bad[:, None, :], 0.0, Q)
    if Q.shape[2] < 4:              # agg < 4 nodes cannot span 4 modes:
        Q = np.concatenate(         # missing modes are inert (zero weight)
            [Q, np.zeros((n_agg, agg, 4 - Q.shape[2]))], axis=2)
    return np.ascontiguousarray(Q.transpose(2, 0, 1).reshape(4, nb_pad))


def linear_coarse_dense_matrix(
    cs: CoarseSpace, offsets: tuple, dia_data, w: np.ndarray,
    *, shift: float = 0.0,
) -> np.ndarray:
    """Dense Galerkin coarse matrix A_c = P^T A P for the per-aggregate
    LINEAR basis (host-side, f64 accumulation).

    P[4i+a, 16 g + 4 m + a] = w[m, i] for g = i//agg (zero otherwise):
    coarse dofs are aggregate-major, then mode-major, then component.  The
    product regroups over node offsets exactly like the smoothed-aggregation
    builder: for each node offset D and mode pair (m, m'), the weighted
    block plane w[m, i] * A_blk[D, i, a, b] * w[m', i+D] accumulates onto
    coarse diagonals via `_agg_diag_add` with dof=16.  Cost: N_D * 16 * 16
    vectorized strided adds over (nb,) — ~seconds at 2.35M rows, once per
    operator preparation."""
    from navierstokes_tpu.ops.plane_dia import node_offsets_from_scalar

    dd = np.asarray(dia_data)
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    nc = 16 * n_agg
    node_offsets = node_offsets_from_scalar(offsets)
    A_blk = _node_block_view(offsets, dd, nb, node_offsets)
    wf = np.asarray(w, dtype=np.float64)

    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for iD, D in enumerate(node_offsets):
        lo, hi = max(0, -D), nb - max(0, D)
        if hi <= lo:
            continue
        blk = A_blk[iD, lo:hi].astype(np.float64)
        for m in range(4):
            for mp in range(4):
                M2 = blk * (wf[m, lo:hi, None, None]
                            * wf[mp, lo + D:hi + D, None, None])
                for a in range(4):
                    for b in range(4):
                        vbuf[:] = 0.0
                        vbuf[lo:hi] = M2[:, a, b]
                        _agg_diag_add(ac, vbuf, D, 4 * m + a, 4 * mp + b,
                                      n_agg, agg, nc, dof=16)
    out = ac.reshape(nc, nc)
    # inert coarse dofs (zeroed weight columns / padding-only aggregates):
    # pin the diagonal so the inverse exists; their restricted residual is
    # identically zero, so they contribute no correction.
    dg = np.abs(np.diagonal(out))
    inert = dg <= 1e-300
    out[np.diag_indices(nc)] += np.where(inert, 1.0, 0.0)
    if shift:
        out[np.diag_indices(nc)] += shift
    return out


def linear_coarse_inverse_dia(
    cs: CoarseSpace, offsets: tuple, dia_data, w: np.ndarray,
    *, shift: float = 0.0,
):
    """Host f64 dense inverse of the linear-basis coarse matrix (same
    accuracy/memory rationale as `coarse_operator_inverse_dia`; requires
    eager operator preparation)."""
    try:
        ac = linear_coarse_dense_matrix(cs, offsets, dia_data, w,
                                        shift=shift)
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError) as e:
        raise ValueError(
            "coarse_basis='linear' requires eager operator preparation "
            "(the default exact-Jacobian flow): the Galerkin product and "
            "its inverse are built on the host in f64"
        ) from e
    dt = dia_data.dtype if hasattr(dia_data, "dtype") else jnp.float32
    return jnp.asarray(np.linalg.inv(ac), dtype=dt)


def restrict_planes_linear(cs: CoarseSpace, rp, nbp: int, w):
    """P^T r on a plane-major padded fine vector -> (16*n_agg,) coarse.

    Coarse ordering: aggregate-major, mode, component (matches
    `linear_coarse_dense_matrix`).  One small batched einsum — the minor
    output dims are coarse-sized.  precision=HIGHEST for the same measured
    reason as `restrict`."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    r3 = rp.reshape(4, nbp)[:, :cs.nb_pad].reshape(
        4, cs.n_agg, cs.agg_size)
    w3 = w.reshape(4, cs.n_agg, cs.agg_size)
    rc = jnp.einsum("cgp,mgp->gmc", r3, w3,
                    precision=jax.lax.Precision.HIGHEST)
    return rc.reshape(-1)


def prolong_planes_linear(cs: CoarseSpace, zc, nbp: int, nb: int, w):
    """P zc: (16*n_agg,) coarse -> plane-major padded fine vector."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    z3 = zc.reshape(cs.n_agg, 4, 4)
    w3 = w.reshape(4, cs.n_agg, cs.agg_size)
    zf = jnp.einsum("gmc,mgp->cgp", z3, w3,
                    precision=jax.lax.Precision.HIGHEST,
                    ).reshape(4, cs.nb_pad)
    zf = jnp.pad(zf, ((0, 0), (0, nbp - cs.nb_pad)))
    mask = (jnp.arange(nbp) < nb)[None, :]
    return jnp.where(mask, zf, jnp.zeros((), zf.dtype)).reshape(-1)


def smoothed_coarse_dense_matrix(
    cs: CoarseSpace, offsets: tuple, dia_data, inv_diag,
    *, omega: float, shift: float = 0.0,
):
    """Dense Petrov-Galerkin coarse matrix for the SMOOTHED-AGGREGATION
    prolongator (host-side, f64 accumulation):

        P = (I - omega D^{-1} A) P0,   R = P0^T
        A_c = P0^T A P0 - omega * P0^T (A D^{-1} A) P0

    Piecewise-constant aggregation thins with mesh size (253 vs 69 outer
    iterations/step at 2.35M vs 117k rows at fixed aggregate geometry);
    Jacobi-smoothing the basis is the classic SA cure, and on this layout it
    is cheap: P is never materialized — the apply side adds one SpMV +
    one D^{-1} per coarse correction (model._prep_operators), and this
    Galerkin product reduces to node-offset-pair block products plus
    strided diagonal adds (contiguous aggregates make every coarse row
    index an arithmetic progression in the aggregate id).

    MEASURED NEGATIVE RESULT:
    on the indefinite NS saddle-point operator the smoothed basis makes the
    two-level preconditioner ~3x WORSE in f64 at matrix 3 and non-convergent
    at 117k rows for every omega in {0.5, 0.6667, 1.0} — classic SA theory
    assumes an (essentially) SPD operator, where I - omega D^{-1} A damps a
    positive-real spectrum; here D^{-1} A has eigenvalues across both
    half-planes, so every fixed omega amplifies some modes (the same
    mechanism as the measured divergence of undamped level-1 Jacobi sweeps
    and odd-order Neumann).  The implementation is kept (algebra
    oracle-tested to 1e-10 in tests/test_coarse_sa.py) with default
    omega = 0.0; the productive scale lever is the dense level-1 coarse
    with tuned aggregate size.

    Structure exploited: the FEM pattern is dense 4x4 node blocks on N_D
    node offsets (see ops.plane_dia), so A D^{-1} A regroups as
    (N_D)^2 batched 4x4 block products — ~65 ms at 117k rows, ~seconds at
    2.35M, once per operator preparation.
    """
    from navierstokes_tpu.ops.plane_dia import node_offsets_from_scalar

    dd = np.asarray(dia_data)
    di = np.asarray(inv_diag)
    nb, agg, n_agg, nc = cs.nb, cs.agg_size, cs.n_agg, cs.nc
    nb_pad = cs.nb_pad
    node_offsets = node_offsets_from_scalar(offsets)

    A_blk = _node_block_view(offsets, dd, nb, node_offsets)
    C_blk = np.matmul(di[None, :, :, :], A_blk)        # D^{-1} A, per offset

    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(nb_pad, dtype=np.float64)
    for iD, D in enumerate(node_offsets):              # P0^T A P0
        for a in range(4):
            for c in range(4):
                vbuf[:nb] = A_blk[iD, :, a, c]
                _agg_diag_add(ac, vbuf, D, a, c, n_agg, agg, nc)
    ac1 = np.zeros(nc * nc, dtype=np.float64)
    for iD1, D1 in enumerate(node_offsets):            # P0^T (A D^{-1} A) P0
        lo, hi = max(0, -D1), nb - max(0, D1)
        if hi <= lo:
            continue
        A1 = A_blk[iD1, lo:hi]
        for iD2, D2 in enumerate(node_offsets):
            M = np.matmul(A1, C_blk[iD2, lo + D1:hi + D1])
            for a in range(4):
                for c in range(4):
                    vbuf[:] = 0.0
                    vbuf[lo:hi] = M[:, a, c]
                    _agg_diag_add(ac1, vbuf, D1 + D2, a, c, n_agg, agg, nc)
    out = (ac - omega * ac1).reshape(nc, nc)
    if shift:
        out[np.diag_indices(nc)] += shift
    return out


def smoothed_coarse_inverse_dia(
    cs: CoarseSpace, offsets: tuple, dia_data, inv_diag,
    *, omega: float, shift: float = 0.0,
):
    """Host f64 dense inverse of the smoothed-aggregation coarse matrix.

    Host-only by design (same accuracy/memory rationale as
    `coarse_operator_inverse_dia`); requires concrete operator data, i.e.
    eager preparation (the default exact-Jacobian flow)."""
    try:
        ac = smoothed_coarse_dense_matrix(
            cs, offsets, dia_data, inv_diag, omega=omega, shift=shift
        )
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerArrayConversionError) as e:
        raise ValueError(
            "coarse_smooth_omega requires eager operator preparation "
            "(jacobian='exact'); the traced (reference-jacobian) path "
            "cannot build the smoothed Galerkin product on host"
        ) from e
    dt = dia_data.dtype if hasattr(dia_data, "dtype") else np.float64
    return jnp.asarray(np.linalg.inv(ac), dtype=dt)


def coarse_operator_inverse(
    cs: CoarseSpace, bcsr_values, row_ids, col_indices, *, shift: float = 0.0
):
    """Dense inverse of A_c = R A P (jittable; built once per operator).

    bcsr_values: (nnzb, 4, 4); row_ids/col_indices: (nnzb,) block coords.
    `shift` regularizes the (possibly singular) coarse pressure block.
    """
    nc = cs.nc
    AI = cs.agg_dev[row_ids]
    AJ = cs.agg_dev[col_indices]
    a4 = jnp.arange(4)
    rows_sc = (4 * AI)[:, None, None] + a4[None, :, None]     # (nnzb, 4, 1)
    cols_sc = (4 * AJ)[:, None, None] + a4[None, None, :]     # (nnzb, 1, 4)
    flat_idx = (rows_sc * nc + cols_sc).reshape(-1)
    Ac = (
        jnp.zeros(nc * nc, dtype=bcsr_values.dtype)
        .at[flat_idx]
        .add(bcsr_values.reshape(-1))
        .reshape(nc, nc)
    )
    if shift:
        Ac = Ac + shift * jnp.eye(nc, dtype=Ac.dtype)
    # Dense inverse via LU against the identity (jnp.linalg: LAPACK on the
    # CPU, cuSOLVER on the GPU); fine at this size.
    return jnp.linalg.inv(Ac)
