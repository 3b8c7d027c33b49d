"""Global FEM assembly: element contributions -> BCSR/ELL operator + residual.

The accelerator re-design of the reference assembly stack
(`precompute_constant_matrices` / `compute_residual_optimized` /
`assemble_jacobian_optimized` / `preassemble_linear_jacobian` /
`add_nonlinear_jacobian_terms`, `src/solve_newton.c:200-615`):

- the block sparsity pattern is computed once on the host (static),
- each element's 16 node-pair 4x4 blocks map to fixed BCSR slots through a
  precomputed scatter map, so value assembly is one `segment_sum` under jit,
- the residual is a direct per-element contraction + scatter-add,
- the J = J_linear + nonlinear(u) split is preserved: linear block values are
  assembled once, the per-Newton-iteration update only recomputes the
  convection terms.

No `omp critical`, no `VecSetValues`: everything is a fused XLA scatter.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.fem import elements as el
from navierstokes_tpu.fem.dirichlet import DirichletBC, build_dirichlet
from navierstokes_tpu.mesh.core import Mesh
from navierstokes_tpu.sparse.bcsr import BCSR4, bcsr_pattern_from_coo
from navierstokes_tpu.sparse.bell import bell_pattern_from_bcsr


@dataclasses.dataclass
class Discretization:
    """Static + device data for one mesh (the problem's 'graph')."""

    mesh: Mesh
    # Device arrays (the hot assembly path)
    tets: jnp.ndarray            # (ne, 4) int32
    vol: jnp.ndarray             # (ne,)
    grad: jnp.ndarray            # (ne, 4, 3)
    h: jnp.ndarray               # (ne,)
    # BCSR pattern + scatter maps — HOST numpy: the BCSR/ELL routes are
    # cold paths (tests, benches); keeping these on device cost ~2 GB of
    # standing HBM at the 2.35M-row scale for arrays the transient solver
    # never touches.  Every use site is jnp-compatible (numpy indices).
    indptr: np.ndarray           # (nb + 1,)
    indices: np.ndarray          # (nnzb,)
    row_ids: np.ndarray          # (nnzb,)
    diag_slots: np.ndarray       # (nb,)
    slot_of_pair: np.ndarray     # (ne * 16,): element (i, j) -> slot
    # block-ELL pattern
    ell_indices: np.ndarray      # (nb, S) host
    slot_of_bcsr: np.ndarray     # (nnzb,): bcsr slot -> ell flat slot
    # scalar-DIA pattern (the gather-free layout — see sparse/dia.py)
    dia_pattern: "DIAPattern"
    dia_flat_map: np.ndarray     # (nnzb*16,) host
    dia_elem_map: jnp.ndarray    # (ne*256,) device: element scalar entry ->
                                 # flat DIA position (direct assembly path)
    bc: DirichletBC

    @property
    def nv(self) -> int:
        return self.mesh.nv

    @property
    def ne(self) -> int:
        return self.mesh.ne

    @property
    def ndof(self) -> int:
        return 4 * self.mesh.nv

    @property
    def nnzb(self) -> int:
        return len(self.indices)

    @property
    def ell_slots(self) -> int:
        return self.ell_indices.shape[1]


def build_discretization(
    mesh: Mesh, dtype=jnp.float64, ell_slots: Optional[int] = None
) -> Discretization:
    coords = jnp.asarray(mesh.coords, dtype=dtype)
    tets = jnp.asarray(mesh.tets)
    a = coords[tets]                              # (ne, 4, 3)
    vol, grad, h = el.batched_geometry(a)

    # Block pattern: all (i, j) node pairs per element (native graph builder
    # when available, numpy fallback otherwise — identical output).
    from navierstokes_tpu import native

    built = native.build_pattern_native(mesh.nv, mesh.tets)
    if built is not None:
        indptr, indices, slot_of_pair = built
    else:
        t = mesh.tets
        rows = np.repeat(t, 4, axis=1).ravel()
        cols = np.tile(t, (1, 4)).ravel()
        indptr, indices, slot_of_pair = bcsr_pattern_from_coo(rows, cols, mesh.nv)
    row_ids = np.repeat(np.arange(mesh.nv, dtype=np.int32), np.diff(indptr))
    diag = np.flatnonzero(indices == row_ids).astype(np.int32)
    if len(diag) != mesh.nv:
        raise ValueError("missing diagonal blocks in FEM pattern")

    ell_indices, slot_of_bcsr = bell_pattern_from_bcsr(indptr, indices, ell_slots)

    from navierstokes_tpu.sparse.dia import build_dia_pattern

    dia_pattern = build_dia_pattern(indptr, indices)
    # Element scalar entry (e, i, j, a, b) -> flat DIA slot, composing the
    # pair->bcsr-slot and bcsr-entry->dia maps.  Enables assembling straight
    # into the flat (K*ndof,) layout with ONE 1-D scatter — no (..., 4, 4)
    # arrays whose minor dims XLA tile-pads 32-64x in HBM.
    dia_elem_map = (
        dia_pattern.flat_map.reshape(-1, 16)[slot_of_pair].reshape(-1)
    )
    max_flat = dia_pattern.K * dia_pattern.ndof
    elem_map_dtype = np.int32 if max_flat < 2**31 else np.int64

    return Discretization(
        mesh=mesh,
        tets=tets,
        vol=vol,
        grad=grad,
        h=h,
        indptr=indptr,
        indices=indices,
        row_ids=row_ids,
        diag_slots=diag,
        slot_of_pair=slot_of_pair,
        ell_indices=ell_indices,
        slot_of_bcsr=slot_of_bcsr,
        dia_pattern=dia_pattern,
        dia_flat_map=dia_pattern.flat_map,
        dia_elem_map=jnp.asarray(dia_elem_map.astype(elem_map_dtype)),
        bc=build_dirichlet(mesh, dtype=dtype),
    )


def save_discretization(disc: Discretization, out_dir: str) -> None:
    """Persist a Discretization to a directory of .npy/.pkl files.

    The host-side pattern build is the setup bottleneck at scale (~10-20
    minutes single-core at 2.35M rows); caching it makes large-mesh bench
    reruns tractable.  Cold-path fields (BCSR/ELL scatter maps) are saved
    too when present so the cache round-trips completely.
    """
    import os
    import pickle

    os.makedirs(out_dir, exist_ok=True)
    with open(f"{out_dir}/mesh.pkl", "wb") as f:
        pickle.dump(disc.mesh, f)
    with open(f"{out_dir}/dia_pattern.pkl", "wb") as f:
        pickle.dump(disc.dia_pattern, f)
    with open(f"{out_dir}/bc.pkl", "wb") as f:
        pickle.dump(
            {
                "is_bc": np.asarray(disc.bc.is_bc),
                "value": np.asarray(disc.bc.value),
                "row_bc": np.asarray(disc.bc.row_bc),
            },
            f,
        )
    def to_host(arr):
        # Chunk multi-GB device->host fetches (the ~3.5 GB dia_elem_map at
        # 2.35M rows) into ~256 MB pieces to bound the host staging copy.
        if getattr(arr, "nbytes", 0) > 256 * 1024 * 1024 and \
                not isinstance(arr, np.ndarray):
            flat = arr.reshape(-1)
            step = (256 * 1024 * 1024) // arr.dtype.itemsize
            return np.concatenate([
                np.asarray(flat[i:i + step])
                for i in range(0, flat.shape[0], step)
            ]).reshape(arr.shape)
        return np.asarray(arr)

    for name in ("tets", "vol", "grad", "h", "dia_elem_map"):
        np.save(f"{out_dir}/{name}.npy", to_host(getattr(disc, name)))
    for name in (
        "indptr", "indices", "row_ids", "diag_slots", "slot_of_pair",
        "ell_indices", "slot_of_bcsr",
    ):
        arr = getattr(disc, name)
        if arr is not None and np.size(arr) > 1:
            np.save(f"{out_dir}/{name}.npy", np.asarray(arr))


def load_discretization(cache_dir: str, dtype=jnp.float32) -> Discretization:
    """Load a Discretization saved by `save_discretization`.

    Cold-path fields missing from the cache (older caches saved only the
    transient-path subset) come back as 1-element dummies — fine for the
    step/stokes path, which never reads them.
    """
    import os
    import pickle

    with open(f"{cache_dir}/mesh.pkl", "rb") as f:
        mesh = pickle.load(f)
    with open(f"{cache_dir}/dia_pattern.pkl", "rb") as f:
        dia_pattern = pickle.load(f)
    with open(f"{cache_dir}/bc.pkl", "rb") as f:
        bcd = pickle.load(f)

    def opt(name, default_shape=(1,), default_dtype=np.int64):
        path = f"{cache_dir}/{name}.npy"
        if os.path.exists(path):
            return np.load(path)
        return np.zeros(default_shape, dtype=default_dtype)

    return Discretization(
        mesh=mesh,
        tets=jnp.asarray(np.load(f"{cache_dir}/tets.npy")),
        vol=jnp.asarray(np.load(f"{cache_dir}/vol.npy"), dtype=dtype),
        grad=jnp.asarray(np.load(f"{cache_dir}/grad.npy"), dtype=dtype),
        h=jnp.asarray(np.load(f"{cache_dir}/h.npy"), dtype=dtype),
        indptr=np.load(f"{cache_dir}/indptr.npy"),
        indices=np.load(f"{cache_dir}/indices.npy"),
        row_ids=opt("row_ids"),
        diag_slots=opt("diag_slots"),
        slot_of_pair=opt("slot_of_pair"),
        ell_indices=opt("ell_indices", (1, 1)),
        slot_of_bcsr=opt("slot_of_bcsr"),
        dia_pattern=dia_pattern,
        dia_flat_map=dia_pattern.flat_map,
        dia_elem_map=jnp.asarray(np.load(f"{cache_dir}/dia_elem_map.npy")),
        bc=DirichletBC(
            is_bc=jnp.asarray(bcd["is_bc"]),
            value=jnp.asarray(bcd["value"], dtype=dtype),
            row_bc=jnp.asarray(bcd["row_bc"]),
        ),
    )


def local_fields(tets, u):
    """Extract per-element nodal fields from the global DoF vector.

    u: (4nv,) -> UL (ne, 3, 4) component-major velocity, PL (ne, 4) pressure.
    """
    u4 = u.reshape(-1, 4)
    ue = u4[tets]                                 # (ne, 4 nodes, 4 dof)
    return ue[:, :, :3].transpose(0, 2, 1), ue[:, :, 3]


# ---------------------------------------------------------------------------
# Residual
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("ndof",))
def assemble_residual(tets, vol, grad, h, u, u_old, dt, reynolds, delta, *, ndof):
    """Nonlinear residual F(u) as one fused elementwise pass + scatter-add."""
    UL, PL = local_fields(tets, u)
    UL_old, _ = local_fields(tets, u_old)
    F_v, F_p = jax.vmap(
        el.element_residual, in_axes=(0, 0, 0, 0, 0, 0, None, None, None)
    )(grad, vol, h, UL, UL_old, PL, dt, reynolds, delta)

    vdofs = (4 * tets)[:, :, None] + jnp.arange(3)[None, None, :]   # (ne, 4, 3)
    pdofs = 4 * tets + 3                                            # (ne, 4)
    F = jnp.zeros(ndof, dtype=u.dtype)
    # element_residual returns F_v as (node, comp); scatter matches vdofs layout
    F = F.at[vdofs.reshape(-1)].add(F_v.reshape(-1))
    F = F.at[pdofs.reshape(-1)].add(F_p.reshape(-1))
    return F


# ---------------------------------------------------------------------------
# Jacobian / operator values
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("terms", "nnzb"))
def assemble_bcsr_values(
    tets, vol, grad, h, UL, dt, reynolds, delta, slot_of_pair, *, terms, nnzb
):
    """Assemble BCSR block values for the selected element terms.

    terms: frozenset — see `elements.element_node_blocks`.  UL may be a dummy
    zero field when no convection terms are selected.
    """

    def one(g, v, hh, ul):
        return el.element_node_blocks(g, v, hh, ul, dt, reynolds, delta, terms=terms)

    blocks = jax.vmap(one)(grad, vol, h, UL)           # (ne, 4, 4, 4, 4)
    flat = blocks.reshape(-1, 4, 4)                    # (ne*16, 4, 4)
    return jax.ops.segment_sum(flat, slot_of_pair, num_segments=nnzb)


@partial(jax.jit, static_argnames=("terms", "K", "ndof", "chunk"))
def assemble_dia_values(
    tets, vol, grad, h, UL, dt, reynolds, delta, dia_elem_map, *,
    terms, K, ndof, chunk: int = 16384
):
    """Assemble straight into the scalar-DIA layout: (K, ndof).

    Scalable path: the BCSR-block route materializes (ne, 4, 4, 4, 4)
    arrays whose minor dims XLA tile-pads to (8, 128) — a 32x HBM inflation
    that OOMs beyond ~500k rows.  Here elements are processed in fixed-size
    chunks inside a fori_loop (bounded intermediates regardless of mesh
    size), each chunk's blocks flattened and scattered with one flat 1-D
    add through the precomputed element-scalar -> DIA map.
    """
    ne = vol.shape[0]
    dtype = vol.dtype

    def one(g, v, hh, ul):
        return el.element_node_blocks(
            g, v, hh, ul, dt, reynolds, delta, terms=terms
        ).reshape(256)

    if ne <= chunk:
        blocks = jax.vmap(one)(grad, vol, h, UL)           # (ne, 256)
        flat = jnp.zeros(K * ndof, dtype=dtype)
        flat = flat.at[dia_elem_map].add(blocks.reshape(-1))
        return flat.reshape(K, ndof)

    n_chunks = -(-ne // chunk)
    ne_pad = n_chunks * chunk
    pad = ne_pad - ne
    # Zero-geometry padding elements contribute zero blocks; their map
    # entries target a sacrificial extra slot.
    grad_p = jnp.pad(grad, ((0, pad), (0, 0), (0, 0)))
    vol_p = jnp.pad(vol, (0, pad))
    h_p = jnp.pad(h, (0, pad))
    UL_p = jnp.pad(UL, ((0, pad), (0, 0), (0, 0)))
    map_p = jnp.pad(
        dia_elem_map.reshape(ne, 256), ((0, pad), (0, 0)),
        constant_values=K * ndof,
    )

    def body(c, flat):
        s = c * chunk
        g = jax.lax.dynamic_slice_in_dim(grad_p, s, chunk)
        v = jax.lax.dynamic_slice_in_dim(vol_p, s, chunk)
        hh = jax.lax.dynamic_slice_in_dim(h_p, s, chunk)
        ul = jax.lax.dynamic_slice_in_dim(UL_p, s, chunk)
        m = jax.lax.dynamic_slice_in_dim(map_p, s, chunk)
        blocks = jax.vmap(one)(g, v, hh, ul)               # (chunk, 256)
        return flat.at[m.reshape(-1)].add(blocks.reshape(-1))

    flat = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros(K * ndof + 1, dtype=dtype)
    )
    return flat[:-1].reshape(K, ndof)


STOKES_TERMS = frozenset({"diffusion"})
LINEAR_TERMS = frozenset({"mass_dt", "diffusion"})
NONLINEAR_TERMS = frozenset({"convection", "convection_jacobian"})
FULL_JACOBIAN_TERMS = LINEAR_TERMS | NONLINEAR_TERMS


def assemble_operator(
    disc: Discretization, u, dt, reynolds, delta, terms
) -> BCSR4:
    """Convenience wrapper returning a BCSR4 (pattern from disc)."""
    UL, _ = local_fields(disc.tets, u)
    values = assemble_bcsr_values(
        disc.tets,
        disc.vol,
        disc.grad,
        disc.h,
        UL,
        dt,
        reynolds,
        delta,
        disc.slot_of_pair,
        terms=terms,
        nnzb=disc.nnzb,
    )
    return BCSR4(indptr=disc.indptr, indices=disc.indices, values=values)
