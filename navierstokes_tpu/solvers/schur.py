"""Pressure Schur-complement (SIMPLE-style) block preconditioning.

The NS operator has the per-node saddle-point block structure (rows/cols
ordered u, v, w, p — `fem/elements.py::element_node_blocks`, re-expressing
`src/solve_newton.c:448-517`):

    A = [ F    B^T ]        F   = M/dt + diffusion (+ convection)
        [ -B   D   ]        B   = divergence,  B^T = pressure gradient
                            D   = Brezzi-Pitkaranta stabilization

The coupled two-level preconditioner treats this indefinite operator with
one aggregation coarse grid; its iteration counts grow with N (74 -> 253
over 117k -> 2.35M rows) because a fixed
coarse space cannot capture the pressure's global coupling.  The classic
physics-aware cure (SIMPLE / pressure-Schur family: Patankar's SIMPLE,
Elman-Silvester-Wathen ch. 9) is a block-triangular preconditioner

    M = [ F_hat    0     ]        solve M z = r:
        [ -B       S_hat ]          z_u = F_hat^{-1} r_u
                                     z_p = S_hat^{-1} (r_p + B z_u)

with S_hat ~ the pressure Schur complement.  Eliminating u gives

    S = D + B F^{-1} B^T,

which is (near-)SPD — exactly the operator class where aggregation
coarse grids and Chebyshev smoothing are *theoretically* sound, unlike
the coupled saddle point (see the measured SA/Chebyshev negatives on the
indefinite spectrum).  The SIMPLE approximation replaces F^{-1} by the
inverse of its 3x3 node-diagonal blocks: S_hat = D + B diag(F)^{-1} B^T —
banded (node offsets of B doubled by the product), assembled on the host
once per operator preparation.

Everything here is accelerator plumbing around that algebra:

  * Sub-block applies (F: 3x3 planes, -B: 1x3, B^T: 3x1, S_hat: 1x1 with
    doubled offsets) all ride the generic plane SpMV
    (`ops.plane_dia.spmv_planes`), paying memory traffic only for the planes
    they touch — F+B+S_hat per apply move ~(9+3+2)/16 of the full
    operator's bytes.
  * Both sub-solves are two-grid cycles: a dense aggregation coarse
    inverse (velocity: 3 dof/aggregate; pressure: 1 dof/aggregate —
    host f64, same accuracy rationale as `coarse.coarse_operator_
    inverse_dia`) plus a diagonal-preconditioned smoother, optionally a
    Chebyshev sweep (`model._make_smoother`) with intervals from host
    power iteration at preparation time.

Plane layout + eager (exact-Jacobian) preparation + single chip only;
`model/navier_stokes.py` validates and routes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.solvers.coarse import (
    CoarseSpace,
    _agg_diag_add,
    _node_block_view,
)


@dataclasses.dataclass(frozen=True)
class SchurStatic:
    """Static (hashable) half of the Schur prep — lives in the jit-static
    prep tuple next to the CoarseSpace, like c_static on the tlp path."""

    s_offsets: tuple          # node offsets of S_hat (doubled band)
    cheby_s: tuple            # (theta, delta, deg) for the S_hat smoother,
                              # or None = one Jacobi application
    cheby_v: tuple            # same for the velocity smoother, or None
    shape: str                # "lower" | "full" (adds the B^T correction)

    def __hash__(self):       # CoarseSpace-style: identity is fine, the
        return id(self)       # tuple is built once per operator prep

    def __eq__(self, other):
        return self is other


def split_blocks(offsets: tuple, dia_data, nb: int, node_offsets: tuple):
    """Host block view (N_D, nb, 4, 4) of the BC-applied operator."""
    return _node_block_view(offsets, np.asarray(dia_data), nb, node_offsets)


def diag_f_inverse(a_blk: np.ndarray, node_offsets: tuple) -> np.ndarray:
    """(nb, 3, 3) inverse of the velocity diagonal blocks (f64).

    Constrained velocity rows are identity rows after `zero_rows_dia`, so
    every diagonal block is nonsingular; mass/dt keeps interior blocks well
    conditioned."""
    i0 = node_offsets.index(0)
    fd = a_blk[i0, :, :3, :3].astype(np.float64)
    return np.linalg.inv(fd)


def build_schur_dia(a_blk: np.ndarray, node_offsets: tuple, nb: int,
                    fd_inv: np.ndarray):
    """S_hat = A_pp - A_pu diag(F)^{-1} A_up as scalar node-DIA (host f64).

    Signs come verbatim from the operator blocks (A_pu = -B, A_pp = D), so
    S_hat = D + B diag(F)^{-1} B^T.  Returns (s_offsets, s_data) with
    s_data[k][i] = S_hat[i, i + s_offsets[k]]; the band is the sumset
    {d1 + d2} of the node offsets (diagonals that come out identically
    zero are pruned)."""
    n_d = len(node_offsets)
    sums = sorted({d1 + d2 for d1 in node_offsets for d2 in node_offsets}
                  | set(node_offsets))
    sidx = {d: k for k, d in enumerate(sums)}
    s = np.zeros((len(sums), nb), dtype=np.float64)

    # A_pp (the stabilization D, plus whatever else lands in the (3,3) entry)
    for i_d, d in enumerate(node_offsets):
        s[sidx[d]] += a_blk[i_d, :, 3, 3].astype(np.float64)

    # - A_pu diag(F)^{-1} A_up, regrouped by node-offset pairs:
    #   S[i, i+d1+d2] -= sum_{c,c'} A_pu[d1][i,c] Fdinv[i+d1][c,c']
    #                                 A_up[d2][i+d1,c']
    for i1, d1 in enumerate(node_offsets):
        lo, hi = max(0, -d1), nb - max(0, d1)
        if hi <= lo:
            continue
        pu = a_blk[i1, lo:hi, 3, :3].astype(np.float64)        # (m, 3)
        w = np.einsum("ic,icq->iq", pu, fd_inv[lo + d1:hi + d1])
        for i2, d2 in enumerate(node_offsets):
            up = a_blk[i2, lo + d1:hi + d1, :3, 3].astype(np.float64)
            s[sidx[d1 + d2], lo:hi] -= np.einsum("iq,iq->i", w, up)

    keep = [k for k in range(len(sums))
            if sums[k] == 0 or np.any(s[k] != 0.0)]
    return tuple(sums[k] for k in keep), np.ascontiguousarray(s[keep])


def velocity_coarse_inverse(cs: CoarseSpace, a_blk: np.ndarray,
                            node_offsets: tuple, *, shift: float = 0.0):
    """Dense inverse of the aggregated velocity block R F P (host f64).

    Piecewise-constant per-component basis, 3 dof/aggregate; coarse dofs
    aggregate-major then component (matches `restrict_planes_n`)."""
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    nc = 3 * n_agg
    ac = np.zeros(nc * nc, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for i_d, d in enumerate(node_offsets):
        for a in range(3):
            for b in range(3):
                vbuf[:] = 0.0
                vbuf[:nb] = a_blk[i_d, :, a, b]
                _agg_diag_add(ac, vbuf, d, a, b, n_agg, agg, nc, dof=3)
    out = ac.reshape(nc, nc)
    dg = np.abs(np.diagonal(out))
    out[np.diag_indices(nc)] += np.where(dg <= 1e-300, 1.0, 0.0)
    if shift:
        out[np.diag_indices(nc)] += shift
    return np.linalg.inv(out)


def scalar_coarse_inverse(cs: CoarseSpace, s_offsets: tuple,
                          s_data: np.ndarray, *, shift: float = 0.0):
    """Dense inverse of the aggregated S_hat (1 dof/aggregate, host f64)."""
    nb, agg, n_agg = cs.nb, cs.agg_size, cs.n_agg
    ac = np.zeros(n_agg * n_agg, dtype=np.float64)
    vbuf = np.zeros(cs.nb_pad, dtype=np.float64)
    for k, d in enumerate(s_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi <= lo:
            continue
        vbuf[:] = 0.0
        vbuf[lo:hi] = s_data[k, lo:hi]
        _agg_diag_add(ac, vbuf, d, 0, 0, n_agg, agg, n_agg, dof=1)
    out = ac.reshape(n_agg, n_agg)
    dg = np.abs(np.diagonal(out))
    out[np.diag_indices(n_agg)] += np.where(dg <= 1e-300, 1.0, 0.0)
    if shift:
        out[np.diag_indices(n_agg)] += shift
    return np.linalg.inv(out)


def _spmv_dia_host(s_offsets: tuple, s_data: np.ndarray, x: np.ndarray):
    y = np.zeros_like(x)
    nb = x.shape[0]
    for k, d in enumerate(s_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi > lo:
            y[lo:hi] += s_data[k, lo:hi] * x[lo + d:hi + d]
    return y


def _spmv_blocks_host(a_blk: np.ndarray, node_offsets: tuple,
                      x: np.ndarray):
    """y (nb, 3) = F x with F the (:3, :3) sub-blocks of a_blk (host)."""
    nb = x.shape[0]
    y = np.zeros_like(x)
    for i_d, d in enumerate(node_offsets):
        lo, hi = max(0, -d), nb - max(0, d)
        if hi > lo:
            y[lo:hi] += np.einsum(
                "iab,ib->ia", a_blk[i_d, lo:hi, :3, :3].astype(np.float64),
                x[lo + d:hi + d],
            )
    return y


def power_lmax_schur(s_offsets: tuple, s_data: np.ndarray,
                     s_dinv: np.ndarray, iters: int = 40) -> float:
    """|lmax| of diag(S)^{-1} S_hat by host power iteration (S_hat ~SPD)."""
    rng = np.random.default_rng(20260820)
    x = rng.standard_normal(s_data.shape[1])
    lam = 1.0
    for _ in range(iters):
        y = s_dinv * _spmv_dia_host(s_offsets, s_data, x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


def power_lmax_velocity(a_blk: np.ndarray, node_offsets: tuple,
                        fd_inv: np.ndarray, iters: int = 40) -> float:
    """|lmax| of diag(F)^{-1} F by host power iteration (spectral-radius
    estimate for the Chebyshev interval; F is nonsymmetric but mass/dt-
    dominated, so the dominant eigenvalue is real-positive in practice)."""
    rng = np.random.default_rng(20260820)
    nb = a_blk.shape[1]
    x = rng.standard_normal((nb, 3))
    lam = 1.0
    for _ in range(iters):
        y = np.einsum("icq,iq->ic", fd_inv,
                      _spmv_blocks_host(a_blk, node_offsets, x))
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            return 1.0
        x = y / lam
    return lam


# -- plane-layout restriction / prolongation (n_comp components) -------------


def restrict_planes_n(cs: CoarseSpace, rp, nbp: int, n_comp: int):
    """R r: (n_comp * nbp,) plane-major -> (n_comp * n_agg,) coarse,
    aggregate-major then component (matches the dense coarse builders)."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    r2 = rp.reshape(n_comp, nbp)[:, :cs.nb_pad]
    rc = r2.reshape(n_comp, cs.n_agg, cs.agg_size).sum(-1)   # (n_comp, n_agg)
    return rc.T.reshape(-1)


def prolong_planes_n(cs: CoarseSpace, zc, nbp: int, nb: int, n_comp: int):
    """P zc: (n_comp * n_agg,) coarse -> (n_comp * nbp,) plane-major."""
    assert cs.nb_pad <= nbp, (cs.nb_pad, nbp)
    z2 = zc.reshape(cs.n_agg, n_comp).T                      # (n_comp, n_agg)
    zf = jnp.broadcast_to(
        z2[:, :, None], (n_comp, cs.n_agg, cs.agg_size)
    ).reshape(n_comp, cs.nb_pad)
    zf = jnp.pad(zf, ((0, 0), (0, nbp - cs.nb_pad)))
    mask = (jnp.arange(nbp) < nb)[None, :]
    return jnp.where(mask, zf, jnp.zeros((), zf.dtype)).reshape(-1)
