"""Component-plane DIA SpMV (ops/plane_dia.py) vs dense ground truth.

The block-structure-aware second layout (the reference's BAIJ8 question,
`src/kernels/baij8_avx512.c`, answered the bandwidth way — see
bench/layout_census.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.ops.plane_dia import (
    extract_planes,
    from_planes,
    node_offsets_from_scalar,
    plane_halo,
    plane_terms,
    spmv_planes,
    to_planes,
)

NODE_OFFS = (-7, -5, -1, 0, 1, 2, 6)


def _random_block_band(nb, node_offs, rng, dtype=np.float32):
    """Dense (4nb, 4nb) matrix with dense 4x4 blocks on the node offsets,
    plus its scalar-DIA (offsets, data)."""
    n = 4 * nb
    dense = np.zeros((n, n), dtype)
    for d in node_offs:
        lo, hi = max(0, -d), min(nb, nb - d)
        blocks = rng.standard_normal((hi - lo, 4, 4)).astype(dtype)
        for i in range(lo, hi):
            dense[4 * i:4 * i + 4, 4 * (i + d):4 * (i + d) + 4] = blocks[i - lo]
    offsets = tuple(sorted({4 * d + e for d in node_offs
                            for e in range(-3, 4)}))
    data = np.zeros((len(offsets), n), dtype)
    for k, off in enumerate(offsets):
        for i in range(max(0, -off), min(n, n - off)):
            data[k, i] = dense[i, i + off]
    return dense, offsets, jnp.asarray(data)


def test_node_offsets_from_scalar():
    offsets = tuple(sorted({4 * d + e for d in NODE_OFFS
                            for e in range(-3, 4)}))
    assert node_offsets_from_scalar(offsets) == tuple(sorted(NODE_OFFS))


def test_plane_roundtrip():
    rng = np.random.default_rng(3)
    nb, nbp = 37, 64
    x = jnp.asarray(rng.standard_normal(4 * nb), jnp.float32)
    assert np.allclose(from_planes(to_planes(x, nb, nbp), nb, nbp), x)


@pytest.mark.parametrize("nb", [300, 2500])
def test_plane_spmv_matches_dense(nb):
    rng = np.random.default_rng(nb)
    dense, offsets, data = _random_block_band(nb, NODE_OFFS, rng)
    node_offs = node_offsets_from_scalar(offsets)
    planes = extract_planes(offsets, data, nb, node_offsets=node_offs)
    assert planes.shape == (4, len(plane_terms(node_offs)), nb)
    nbp = nb + 13                      # zero-padded nodes come out zero
    padded = extract_planes(offsets, data, nb, node_offsets=node_offs,
                            nbp=nbp)
    assert padded.shape == (4, len(plane_terms(node_offs)), nbp)

    x = jnp.asarray(rng.standard_normal(4 * nb), jnp.float32)
    xp = to_planes(x, nb, nbp)
    yp = spmv_planes(node_offs, padded, xp)
    assert not np.any(np.asarray(yp).reshape(4, nbp)[:, nb:])
    y = from_planes(yp, nb, nbp)
    ref = dense @ np.asarray(x)
    err = np.linalg.norm(np.asarray(y) - ref) / np.linalg.norm(ref)
    assert err < 1e-5, err


def test_extract_planes_values():
    """planes[a, j=(b, D)][i] == A[4i+a, 4(i+D)+b] exactly."""
    rng = np.random.default_rng(7)
    nb = 50
    dense, offsets, data = _random_block_band(nb, (-2, 0, 1), rng)
    node_offs = node_offsets_from_scalar(offsets)
    planes = np.asarray(extract_planes(offsets, data, nb,
                                       node_offsets=node_offs))
    terms = plane_terms(node_offs)
    for a in range(4):
        for j, (b, d) in enumerate(terms):
            for i in (0, 1, nb // 2, nb - 2, nb - 1):
                if 0 <= i + d < nb:
                    assert planes[a, j, i] == dense[4 * i + a,
                                                    4 * (i + d) + b]


def test_plane_mode_solver_matches_scalar():
    """spmv='plane' end-to-end (stokes + one Newton step) == scalar path.

    The whole Krylov space runs in component-plane layout; conversions
    happen only at the solve boundary, so agreement to f64 GMRES tolerance
    validates the plane operator, the plane D^{-1}, the coarse round-trip,
    and the plane-native residual at once."""
    import dataclasses

    from navierstokes_tpu.config import NSConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = channel_mesh(6, 3, 3, length=3.0, obstacle=True)
    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4)
    cfg = NSConfig(dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1,
                   dtype="float64", krylov=kr, stokes_krylov=kr)
    krp = dataclasses.replace(kr, spmv="plane")
    cfg_p = dataclasses.replace(cfg, krylov=krp, stokes_krylov=krp)

    s = NavierStokesSolver(mesh, cfg)
    sp = NavierStokesSolver(mesh, cfg_p, disc=s.disc)
    assert sp._exact_prep[0] == "tlp" and s._exact_prep[0] == "tl"
    assert sp._res_planes and not s._res_planes          # layout marker
    assert sp._res_A.ndim == 3 and sp._res_M.ndim == 3   # shared plane ops

    u0 = s.stokes_init()
    u0p = sp.stokes_init()
    err0 = np.linalg.norm(np.asarray(u0p) - np.asarray(u0)) / max(
        np.linalg.norm(np.asarray(u0)), 1e-30)
    assert err0 < 1e-8, f"stokes disagreement {err0}"

    du = jnp.zeros_like(u0)
    u1, _, st = s.step(u0, u0, du)
    u1p, _, stp = sp.step(u0, u0, du)
    assert bool(st.converged) and bool(stp.converged)
    err = np.linalg.norm(np.asarray(u1p) - np.asarray(u1)) / np.linalg.norm(
        np.asarray(u1))
    assert err < 1e-8, f"plane-mode step disagreement {err}"


def _random_planes(n_out, n_in, nbp, node_offs, rng, dtype):
    """Random (n_out, NT, nbp) plane data and its dense plane-major matrix:
    row a*nbp + i, column b*nbp + i + D holds planes[a, j=(b, D), i]."""
    terms = plane_terms(node_offs, n_in)
    data = rng.standard_normal((n_out, len(terms), nbp)).astype(dtype)
    dense = np.zeros((n_out * nbp, n_in * nbp), dtype)
    for a in range(n_out):
        for j, (b, d) in enumerate(terms):
            for i in range(max(0, -d), min(nbp, nbp - d)):
                dense[a * nbp + i, b * nbp + i + d] = data[a, j, i]
    return data, dense


SUB_BLOCKS = [(4, 4), (3, 3), (1, 3), (3, 1), (1, 1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_out,n_in", SUB_BLOCKS)
def test_spmv_planes_sub_blocks_vs_dense(n_out, n_in, dtype):
    """Every sub-block shape the Schur preconditioner applies (full 4x4, F
    3x3, -B 1x3, B^T 3x1, S_hat 1x1) against a dense product."""
    rng = np.random.default_rng(10 * n_out + n_in)
    nbp = 97
    data, dense = _random_planes(n_out, n_in, nbp, NODE_OFFS, rng, dtype)
    x = rng.standard_normal(n_in * nbp).astype(dtype)
    y = spmv_planes(NODE_OFFS, jnp.asarray(data), jnp.asarray(x))
    assert y.dtype == dtype and y.shape == (n_out * nbp,)
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    err = np.linalg.norm(np.asarray(y, np.float64) - ref) / np.linalg.norm(ref)
    assert err < (1e-5 if dtype == np.float32 else 1e-13), err


@pytest.mark.parametrize("n_out,n_in", [(4, 4), (1, 3)])
def test_spmv_planes_prehalo_matches_zero_padding(n_out, n_in):
    """x_prehalo=True with zero ghost nodes == the plain (self-padding)
    form; with nonzero ghosts it picks them up at the band edges."""
    rng = np.random.default_rng(5)
    nbp = 64
    h = plane_halo(NODE_OFFS)
    data, _ = _random_planes(n_out, n_in, nbp, NODE_OFFS, rng, np.float64)
    data = jnp.asarray(data)
    x = rng.standard_normal((n_in, nbp))
    y = spmv_planes(NODE_OFFS, data, jnp.asarray(x.ravel()))
    xh = np.pad(x, ((0, 0), (h, h)))
    yh = spmv_planes(NODE_OFFS, data, jnp.asarray(xh.ravel()),
                     x_prehalo=True)
    np.testing.assert_array_equal(np.asarray(yh), np.asarray(y))
    xh[:, :h] = 1.0
    yg = spmv_planes(NODE_OFFS, data, jnp.asarray(xh.ravel()),
                     x_prehalo=True)
    assert not np.allclose(np.asarray(yg), np.asarray(y))


def test_plane_layout_pads_to_whole_aggregates():
    """Single-device plane layout: nbp is the smallest multiple of the
    aggregate size covering the nodes (what the plane restriction needs)."""
    from navierstokes_tpu.config import NSConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    kr = SolverConfig(preconditioner="two_level", coarse_agg=7, spmv="plane")
    s = NavierStokesSolver(channel_mesh(6, 3, 3, length=3.0),
                           NSConfig(dtype="float64", krylov=kr,
                                    stokes_krylov=kr))
    nb = s.disc.mesh.nv
    nbp = s._plane_layout(nb, NODE_OFFS)
    assert nbp % 7 == 0 and nb <= nbp < nb + 7
    prep = s._exact_prep
    assert prep[0] == "tlp" and prep[2].shape[2] == nbp == prep[7]
