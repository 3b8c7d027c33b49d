"""SpMV / matrix-powers benchmark driver — the mpk suite equivalent.

Reproduces the reference's benchmark tables (`mpk/log/log_SPMV.txt`,
`log_2SPMV.txt`, `log_SPM2V.txt`) in the same format:

    Matrix loaded: <rows> rows, <nnz> nonzeros
    SpMV <variant> : <t> us | <speedup>x | rel err = <e>

over the same 10-matrix scaling series (regenerated from the synthetic
channel meshes, since `mat/` is stripped from the reference repo).

Usage:
    python -m navierstokes_tpu.bench.spmv_bench [--matrices 1,2,3] \
        [--kernel spmv|spm2v|spm3v|spm4v|2spmv] [--dtype float32]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run_one(matrix_id: int, kernel: str, dtype_str: str, disc=None,
            ortho: bool = False):
    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.bench.timing import chained_op_time, rel_error
    from navierstokes_tpu.fem.assembly import (
        LINEAR_TERMS,
        assemble_operator,
        build_discretization,
    )
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.ops.mpk import matrix_power
    from navierstokes_tpu.ops.spmv import spmv_bcsr_ref, spmv_bell, spmv_dia
    from navierstokes_tpu.sparse.bell import bell_from_bcsr
    from navierstokes_tpu.sparse.dia import dia_values_from_bcsr_values

    dtype = jnp.dtype(dtype_str)
    if disc is None:
        mesh = scaling_series_mesh(matrix_id)
        disc = build_discretization(mesh, dtype=dtype)
    pat = disc.dia_pattern
    nnz = pat.nnz
    print(f"Matrix loaded: {disc.ndof} rows, {nnz} nonzeros", flush=True)

    # DIA-direct assembly scales to the full series (the block-form oracle
    # arrays are built only up to ~200k rows).
    from navierstokes_tpu.fem.assembly import assemble_dia_values

    dummy_UL = jnp.zeros((disc.ne, 3, 4), dtype=dtype)
    dia_data = assemble_dia_values(
        disc.tets, disc.vol, disc.grad, disc.h, dummy_UL, 0.001, 300.0, 0.05,
        disc.dia_elem_map, terms=LINEAR_TERMS, K=pat.K, ndof=disc.ndof,
    )
    dia_bf16 = dia_data.astype(jnp.bfloat16)
    offsets = pat.offsets

    # Block-format variants only at sizes where their padded layouts fit.
    with_blocks = disc.ndof <= 200_000
    if with_blocks:
        op = assemble_operator(
            disc, jnp.zeros(disc.ndof, dtype), 0.001, 300.0, 0.05,
            LINEAR_TERMS,
        )
        ell = bell_from_bcsr(op)
        idx = jnp.asarray(ell.indices)
        row_ids = jnp.asarray(op.row_ids())
        bcsr_idx = jnp.asarray(op.indices)

    k = {"spmv": 1, "2spmv": 2, "spm2v": 2, "spm3v": 3, "spm4v": 4}[kernel]
    label = {"spmv": "SpMV", "2spmv": "2SpMV", "spm2v": "SpM2V",
             "spm3v": "SpM3V", "spm4v": "SpM4V"}[kernel]
    if ortho:
        label += "+ortho"

    def cgs2_hook(V, y):
        """CGS2 projection of y against the 50-vector model basis — the
        CA-GMRES dot-product barrier the reference's 2SpMV driver models
        between its chained SpMVs (`mpk/2SpMV.cpp:3-28,109-116`: a 50-vector
        sin basis + Gram-Schmidt sweep).  precision=HIGHEST on every GEMV
        touching solver-style vectors (bf16 rounding rule, CLAUDE.md)."""
        hi = jax.lax.Precision.HIGHEST
        for _ in range(2):
            h = jnp.einsum("mn,n->m", V, y, precision=hi)
            y = y - jnp.einsum("mn,m->n", V, h, precision=hi)
        return y

    # Variant entries are SINGLE-APPLY steppers (u, *operands) -> A u; the
    # timing site chains them k times (and inserts the ortho hook between
    # applications for 2SpMV+ortho).  `extra` may carry layout converters
    # ("x"/"post").
    variants = []
    if with_blocks:
        variants += [
            ("oracle (segment-sum)",
             lambda u, vals: spmv_bcsr_ref(row_ids, bcsr_idx, vals, u),
             (op.values,), {}),
            ("block-ELL gather",
             lambda u, vals: spmv_bell(idx, vals, u), (ell.values,), {}),
        ]
    variants += [
        ("DIA",
         lambda u, data: spmv_dia(offsets, data, u), (dia_data,), {}),
        ("DIA bf16",
         lambda u, data: spmv_dia(offsets, data, u).astype(dtype),
         (dia_bf16,), {}),
    ]
    # Component-plane (by-component-ordering) layout: 16 plane couplings x
    # N_D node diagonals = 0.74x the scalar-DIA bytes (bench/layout_census)
    # — the BAIJ8 "second block layout" experiment, won on bandwidth
    # instead of register reuse.  Timed in its native layout (a plane-layout
    # solver converts only at step boundaries); correctness checked through
    # the conversions.
    from navierstokes_tpu.ops.plane_dia import (
        extract_planes,
        from_planes,
        node_offsets_from_scalar,
        spmv_planes,
        to_planes,
    )

    noffs = node_offsets_from_scalar(offsets)
    nb = disc.ndof // 4
    planes = extract_planes(offsets, dia_data, nb, node_offsets=noffs)
    variants += [
        (f"DIA plane-major (N_D={len(noffs)})",
         lambda u, d4: spmv_planes(noffs, d4, u),
         (planes,),
         {"x": lambda v: to_planes(v, nb, nb),
          "post": lambda v: from_planes(v, nb, nb)}),
    ]

    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(disc.ndof), dtype=dtype
    )
    # Per-variant operator footprint next to each timing — the
    # `src/benchmark_spmv.c:167-207` memory-estimate analog; the bytes a
    # layout streams per SpMV bound its time.
    raw = nnz * jnp.dtype(dtype).itemsize
    y_ref = None
    t_ref = None
    # The ortho-hook basis in the NATURAL vector layout; per-variant the
    # rows are converted to the kernel's native layout (the permutation is
    # orthogonal and pad slots are zero, so the projected result maps back
    # identically — rel err stays meaningful across layouts).
    V_nat = None
    if ortho and kernel == "2spmv":
        j = np.arange(disc.ndof, dtype=np.float64)
        V_nat = jnp.asarray(
            np.sin(0.001 * j[None, :] + np.arange(50)[:, None]), dtype=dtype
        )
    for name, fn1, operands, extra in variants:
        # extra: {"x": to-native-layout, "post": back} for variants whose
        # kernel runs in a different vector layout (timed native — the
        # conversions happen once per solve, not per SpMV).
        to_l = extra.get("x", lambda v: v)
        post = extra.get("post", lambda v: v)
        if V_nat is not None:
            Vb = jax.vmap(to_l)(V_nat)

            def fn(v, Vb, *ops, _s=fn1):
                y = v
                for i in range(k):
                    if i:
                        y = cgs2_hook(Vb, y)
                    y = _s(y, *ops)
                return y

            operands = (Vb,) + operands
        else:

            def fn(v, *ops, _s=fn1):
                y = v
                for _ in range(k):
                    y = _s(y, *ops)
                return y

        mb = sum(o.nbytes for o in operands) / 1e6
        infl = sum(o.nbytes for o in operands) / raw
        xl = to_l(x)
        try:
            y = np.asarray(post(fn(xl, *operands)))
            t = chained_op_time(fn, xl, operands=operands)
        except Exception as e:  # no silent caps: report and keep sweeping
            msg = str(e).splitlines()[0][:160]
            print(f"{label} {name} : FAILED ({msg})", flush=True)
            continue
        us = t * 1e6
        if y_ref is None:
            y_ref = y
            t_ref = t
            print(
                f"{label} {name} : {us:8.1f} us | ref | ref | "
                f"{mb:8.1f} MB ({infl:.2f}x nnz)",
                flush=True,
            )
        else:
            err = rel_error(y, y_ref)
            print(
                f"{label} {name} : {us:8.1f} us | {t_ref / t:.2f}x | "
                f"rel err = {err:.3e} | {mb:8.1f} MB ({infl:.2f}x nnz)",
                flush=True,
            )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--matrices", default="1,2,3,4,5,6",
                   help="comma-separated matrix ids 1-10")
    p.add_argument("--kernel", default="spmv",
                   help="comma-separated subset of spmv,2spmv,spm2v,spm3v,spm4v; all "
                        "kernels at one size share the discretization "
                        "(host pattern build dominates setup at 500k+ rows)")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--ortho", action="store_true",
                   help="2spmv only: insert a CGS2 projection against a "
                        "50-vector model basis between the chained SpMVs "
                        "(the CA-GMRES dot-product barrier the reference's "
                        "2SpMV driver models, mpk/2SpMV.cpp:3-28)")
    p.add_argument("--disc-cache", default=None,
                   help="directory holding per-matrix discretization caches "
                        "(<dir>/m<id>/), created on first use")
    args = p.parse_args(argv)
    kernels = args.kernel.split(",")
    for kn in kernels:
        if kn not in ("spmv", "2spmv", "spm2v", "spm3v", "spm4v"):
            p.error(f"unknown kernel {kn}")
    if args.ortho and kernels != ["2spmv"]:
        p.error("--ortho applies to --kernel 2spmv only")
    for mid in (int(t) for t in args.matrices.split(",")):
        disc = None
        if args.disc_cache or len(kernels) > 1:
            import jax.numpy as jnp

            from navierstokes_tpu.fem.assembly import (
                build_discretization,
                load_discretization,
                save_discretization,
            )
            from navierstokes_tpu.mesh.box import scaling_series_mesh

            cache = f"{args.disc_cache}/m{mid}" if args.disc_cache else None
            import os

            if cache and os.path.exists(f"{cache}/mesh.pkl"):
                disc = load_discretization(cache, dtype=jnp.dtype(args.dtype))
            else:
                disc = build_discretization(
                    scaling_series_mesh(mid), dtype=jnp.dtype(args.dtype)
                )
                if cache:
                    save_discretization(disc, cache)
        for kn in kernels:
            run_one(mid, kn, args.dtype, disc=disc, ortho=args.ortho)


if __name__ == "__main__":
    main()
