"""Operator-layout storage census over the scaling-series matrices.

Answers the reference's "second block size" question (`baij8_avx512.c`:
does a different block layout beat the default?) the bandwidth way: the SpMV
is memory-bandwidth-bound (a pure stream with no reuse beyond the x window),
so a layout can only win by moving FEWER BYTES while staying gather-free.
This census computes, from the real block patterns of matrices 1-10, the
bytes each candidate layout must stream per SpMV:

  raw/BAIJ4   nnzb * 16 values            — compact, but needs per-block
                                            column gathers (block-ELL)
  scalar-DIA  K * ndof values             — the shipped layout: zero
                                            gathers, statically shifted
                                            contiguous slices
  block-DIA   N_D * 16 * nb values        — the BAIJ8-analog candidate:
                                            dense 4x4 blocks on N_D node
                                            diagonals (gather-free like
                                            scalar-DIA, denser iff the
                                            scalar band has holes)

Because each node diagonal d covers the 7 scalar diagonals {4d-3..4d+3}
and adjacent node diagonals overlap in 3 of them, a near-contiguous band
gives K ~= 4*N_D + 3: scalar-DIA is then already within ~O(3/K) of the
block-compact layout, and the census quantifies exactly that.

Usage:
    python -m navierstokes_tpu.bench.layout_census [--max-id 8]

Conclusion recorded in PARITY.md #11.
"""

from __future__ import annotations

import argparse
import time


def census_one(matrix_id: int) -> dict:
    import numpy as np

    from navierstokes_tpu import native
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.sparse.bcsr import bcsr_pattern_from_coo
    from navierstokes_tpu.sparse.dia import build_dia_pattern

    mesh = scaling_series_mesh(matrix_id)
    t0 = time.perf_counter()
    built = native.build_pattern_native(mesh.nv, mesh.tets)
    if built is not None:
        indptr, indices, _ = built
    else:
        t = mesh.tets
        rows = np.repeat(t, 4, axis=1).ravel()
        cols = np.tile(t, (1, 4)).ravel()
        indptr, indices, _ = bcsr_pattern_from_coo(rows, cols, mesh.nv)
    pat = build_dia_pattern(indptr, indices)
    row_ids = np.repeat(np.arange(mesh.nv, dtype=np.int64), np.diff(indptr))
    node_offsets = np.unique(indices.astype(np.int64) - row_ids)
    nd = len(node_offsets)
    nb, nnzb, ndof = mesh.nv, len(indices), 4 * mesh.nv
    k = pat.K
    mb = 4e-6  # f32 bytes -> MB
    return {
        "id": matrix_id, "ndof": ndof, "nnzb": nnzb, "K": k, "N_D": nd,
        "span_contig": 4 * nd + 3,     # K if the node band had no holes
        "raw_mb": round(nnzb * 16 * mb, 1),
        "dia_mb": round(k * ndof * mb, 1),
        "bdia_mb": round(nd * 16 * nb * mb, 1),
        "bdia_vs_dia": round((nd * 16 * nb) / (k * ndof), 3),
        "build_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--max-id", type=int, default=10)
    p.add_argument("--ids", type=str, default=None,
                   help="comma-separated matrix ids (overrides --max-id)")
    args = p.parse_args(argv)
    ids = ([int(s) for s in args.ids.split(",")] if args.ids
           else range(1, args.max_id + 1))
    hdr = (f"{'id':>2} {'ndof':>9} {'nnzb':>9} {'K':>4} {'N_D':>4} "
           f"{'4N_D+3':>6} {'raw MB':>8} {'DIA MB':>8} {'bDIA MB':>8} "
           f"{'bDIA/DIA':>8}")
    print(hdr, flush=True)
    for mid in ids:
        r = census_one(mid)
        print(f"{r['id']:>2} {r['ndof']:>9} {r['nnzb']:>9} {r['K']:>4} "
              f"{r['N_D']:>4} {r['span_contig']:>6} {r['raw_mb']:>8} "
              f"{r['dia_mb']:>8} {r['bdia_mb']:>8} {r['bdia_vs_dia']:>8}",
              flush=True)


if __name__ == "__main__":
    main()
