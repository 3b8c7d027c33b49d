"""Matrix-generator app — the `src/create_mat.c` equivalent.

Assembles the NS/Stokes operator for a mesh of the scaling series (or a Gmsh
file) with BCs applied, and saves it in the formats the benchmark/mpk layers
consume: MatrixMarket `.mtx` (scalar, like `save_matrix_mtx`) and `.npz`
(pattern + block values, the PETSc-binary analog).

Usage:
    python -m navierstokes_tpu.bench.create_mat --matrix-id 3 --out mat/
    python -m navierstokes_tpu.bench.create_mat --msh mesh.msh --out mat/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    # Host tool: run on CPU with full float64 regardless of the accelerator.
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        FULL_JACOBIAN_TERMS,
        LINEAR_TERMS,
        STOKES_TERMS,
        assemble_operator,
        build_discretization,
    )
    from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr
    from navierstokes_tpu.io.mtx import write_mtx, write_mtx_by_component
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.mesh.gmsh import read_gmsh
    from navierstokes_tpu.sparse.bcsr import BCSR4

    p = argparse.ArgumentParser()
    p.add_argument("--matrix-id", type=int, default=None)
    p.add_argument("--msh", default=None)
    p.add_argument("--out", default="mat")
    p.add_argument("--terms", default="linear",
                   choices=["stokes", "linear", "full"])
    p.add_argument("--dtype", default="float64")
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--reynolds", type=float, default=300.0)
    p.add_argument("--delta", type=float, default=0.05)
    args = p.parse_args(argv)

    if (args.matrix_id is None) == (args.msh is None):
        p.error("exactly one of --matrix-id / --msh required")

    mesh = (
        read_gmsh(args.msh) if args.msh else scaling_series_mesh(args.matrix_id)
    )
    name = (
        os.path.splitext(os.path.basename(args.msh))[0]
        if args.msh
        else f"matrix{args.matrix_id}"
    )
    terms = {
        "stokes": STOKES_TERMS,
        "linear": LINEAR_TERMS,
        "full": FULL_JACOBIAN_TERMS,
    }[args.terms]

    dtype = jnp.dtype(args.dtype)
    disc = build_discretization(mesh, dtype=dtype)
    u0 = jnp.zeros(disc.ndof, dtype)
    op = assemble_operator(disc, u0, args.dt, args.reynolds, args.delta, terms)
    values = zero_rows_bcsr(
        op.values, disc.row_ids, jnp.asarray(disc.indices), disc.diag_slots,
        disc.bc.row_bc,
    )
    op = BCSR4(indptr=op.indptr, indices=op.indices, values=values)

    os.makedirs(args.out, exist_ok=True)
    # The reference emits the operator three ways per mesh
    # (`src/create_mat.c:376-484`): AIJ by-component (node + comp*nv), AIJ
    # block-node scalar (4*node + comp, "aijp"), and BAIJ4 block-node.  The
    # two block-node scalar expansions carry identical entries; the blocked
    # one additionally gets the .npz with the block structure.
    aij_path = os.path.join(args.out, f"{name}_aij.mtx")
    write_mtx_by_component(aij_path, op, mesh.nv)
    aijp_path = os.path.join(args.out, f"{name}_aijp.mtx")
    write_mtx(aijp_path, op)
    mtx_path = os.path.join(args.out, f"{name}_baij4.mtx")
    write_mtx(mtx_path, op)
    npz_path = os.path.join(args.out, f"{name}_baij4.npz")
    np.savez_compressed(
        npz_path,
        indptr=op.indptr,
        indices=op.indices,
        values=np.asarray(op.values),
    )
    print(f"wrote {aij_path}, {aijp_path}, {mtx_path} and {npz_path}: "
          f"{disc.ndof} rows, {op.nnz} nonzeros")


if __name__ == "__main__":
    main()
