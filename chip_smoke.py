"""Smoke test of the transient Navier-Stokes solver on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases 1-5
    python chip_smoke.py --four    # four GPUs: distributed parity + m8 steps

One process; phases run in order and any failure exits non-zero without
printing the result line.

1. Device: JAX must find a GPU (no CPU fallback); prints the device kind
   and count, `nvidia-smi` name and power limit, and the compile cache.
2. Kernels at real widths: the component-plane SpMV (`ops.plane_dia`)
   against the scalar-DIA reference (`ops.spmv.spmv_dia`) at m6 and m8 —
   the full 4x4 operator in f32 (relative L2 <= 1e-5: 60-term sums in
   another order) and f64 (<= 1e-12), and at m8 the F (3x3), -B (1x3),
   B^T (3x1) and S_hat (1x1) sub-blocks in f32; then SpMV time and
   achieved GB/s (bytes from shapes over measured time).
3. Main path at m6 (117,500 rows, Re=300, dt=1e-3, delta=0.05) through
   `navierstokes_tpu.run.main` with `--save`: Newton converged every step,
   finite state, exact inlet profile, zero obstacle velocity, `.dat`
   header, `auto` -> two_level + coarse_cheby=3.
4. f32 against f64 at m6: the same steps in f64 at reference-grade
   tolerances with the same preconditioner schedule; relative L2 drift of
   the f32 state < 5e-3 (the bound of tests/test_accuracy.py).
5. Schur tier at m8 (511,024 rows) through `run.main`: the checks of
   phase 3, `auto` -> schur + schur_v_cheby=2.
--four (and only then): DistributedNavierStokesSolver on 4 GPUs at m6 in
f64 against the single-GPU solver on the same band-ordered mesh (rel err
< 1e-8, equal Newton counts, linear iterations within +-2), then >= 3 f32
distributed steps at m8.

The last line of standard output is the JSON result
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

F32_TOL = 1e-5
F64_TOL = 1e-12
DRIFT_TOL = 5e-3


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, from a child process that stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def check_device(jax):
    """The devices JAX found; raises unless they are GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {devs[0].platform} devices ({devs[0]})")
    return devs


def contract_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def rel_l2(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


@contextlib.contextmanager
def x64(enabled: bool):
    import jax

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


# -- phase 2: kernels --------------------------------------------------------


def linear_operator(matrix_id: int):
    """(disc, offsets, dia_data) of the f32 linear Jacobian at `matrix_id`
    (the operator the transient step applies), assembled on the device."""
    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        LINEAR_TERMS,
        assemble_dia_values,
        build_discretization,
    )
    from navierstokes_tpu.mesh.box import scaling_series_mesh

    disc = build_discretization(scaling_series_mesh(matrix_id),
                                dtype=jnp.float32)
    pat = disc.dia_pattern
    data = assemble_dia_values(
        disc.tets, disc.vol, disc.grad, disc.h,
        jnp.zeros((disc.ne, 3, 4), jnp.float32), 1e-3, 300.0, 0.05,
        disc.dia_elem_map, terms=LINEAR_TERMS, K=pat.K, ndof=disc.ndof,
    )
    return disc, pat.offsets, data


def time_apply(fn, x, reps: int = 50) -> float:
    """Seconds per application of fn, from a jitted chain of data-dependent
    applications (slope between reps and 4*reps, best of 3)."""
    import jax

    c = 1.0 / float(np.max(np.abs(np.asarray(fn(x)))))

    @jax.jit
    def chain(v, n):
        return jax.lax.fori_loop(0, n, lambda i, u: fn(u) * c, v)

    def run(n):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            chain(x, n).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    chain(x, 2).block_until_ready()
    return (run(4 * reps) - run(reps)) / (3 * reps)


def plane_bytes(planes, n_in: int) -> int:
    n_out, nt, nbp = planes.shape
    return planes.dtype.itemsize * nbp * (n_out * nt + n_in + n_out)


def sub_block(planes, offsets, data, noffs, rows, cols):
    """Plane stack of the (rows x cols) sub-block and the scalar-DIA data
    of the same sub-block embedded in the 4x4 operator (other entries 0)."""
    import jax.numpy as jnp

    from navierstokes_tpu.ops.plane_dia import plane_terms

    terms = plane_terms(noffs)
    keep = [j for j, (b, _) in enumerate(terms) if b in cols]
    sub = planes[jnp.asarray(rows)][:, jnp.asarray(keep)]
    n = data.shape[1]
    a = np.arange(n) % 4
    mask = np.stack([np.isin(a, rows) & np.isin((a + k) % 4, cols)
                     for k in offsets])
    return sub, data * jnp.asarray(mask, data.dtype)


def phase_kernels(matrix_ids=(6, 8)):
    import jax.numpy as jnp

    from navierstokes_tpu.ops.plane_dia import (
        extract_planes,
        from_planes,
        node_offsets_from_scalar,
        spmv_planes,
        to_planes,
    )
    from navierstokes_tpu.ops.spmv import spmv_dia

    for mid in matrix_ids:
        disc, offsets, data = linear_operator(mid)
        noffs = node_offsets_from_scalar(offsets)
        nb = disc.mesh.nv
        x = jnp.asarray(np.random.default_rng(mid).standard_normal(4 * nb),
                        jnp.float32)
        planes = extract_planes(offsets, data, nb, node_offsets=noffs)

        def plane_full(p, v):
            return from_planes(spmv_planes(noffs, p, to_planes(v, nb, nb)),
                               nb, nb)

        err = rel_l2(plane_full(planes, x), spmv_dia(offsets, data, x))
        log(f"kernels m{mid} rows={4 * nb} 4x4 f32 rel_l2={err:.3e} "
            f"(tol {F32_TOL:g})")
        assert err <= F32_TOL, err
        with x64(True):
            d64, x64v = data.astype(jnp.float64), x.astype(jnp.float64)
            err = rel_l2(plane_full(planes.astype(jnp.float64), x64v),
                         spmv_dia(offsets, d64, x64v))
        log(f"kernels m{mid} rows={4 * nb} 4x4 f64 rel_l2={err:.3e} "
            f"(tol {F64_TOL:g})")
        assert err <= F64_TOL, err

        if mid == max(matrix_ids):
            _check_sub_blocks(disc, offsets, data, noffs, planes, x)

        xp = to_planes(x, nb, nb)
        t = time_apply(lambda v: spmv_planes(noffs, planes, v), xp)
        gbs = plane_bytes(planes, 4) / t / 1e9
        log(f"timing m{mid} plane_spmv f32: {t * 1e6:.2f} us "
            f"{gbs:.1f} GB/s (bytes from shapes)")
        del disc, data, planes


def _check_sub_blocks(disc, offsets, data, noffs, planes, x):
    import jax.numpy as jnp

    from navierstokes_tpu.ops.plane_dia import spmv_planes
    from navierstokes_tpu.ops.spmv import spmv_dia
    from navierstokes_tpu.solvers import schur as sch

    nb = disc.mesh.nv
    x4 = np.asarray(x).reshape(nb, 4)
    for name, rows, cols in (("F", (0, 1, 2), (0, 1, 2)),
                             ("-B", (3,), (0, 1, 2)),
                             ("B^T", (0, 1, 2), (3,))):
        sub, masked = sub_block(planes, offsets, data, noffs, rows, cols)
        xin = jnp.asarray(x4[:, list(cols)].T.reshape(-1))
        y = spmv_planes(noffs, sub, xin)
        xs = np.zeros_like(x4)
        xs[:, list(cols)] = x4[:, list(cols)]
        ref = np.asarray(spmv_dia(offsets, masked, jnp.asarray(xs.ravel())))
        ref = ref.reshape(nb, 4)[:, list(rows)].T.reshape(-1)
        err = rel_l2(y, ref)
        log(f"kernels sub-block {name} ({len(rows)}x{len(cols)}) f32 "
            f"rel_l2={err:.3e} (tol {F32_TOL:g})")
        assert err <= F32_TOL, (name, err)
    a_blk = sch.split_blocks(offsets, np.asarray(data, np.float64), nb,
                             noffs)
    s_offs, s_np = sch.build_schur_dia(a_blk, noffs, nb,
                                       sch.diag_f_inverse(a_blk, noffs))
    s32 = jnp.asarray(s_np, jnp.float32)
    xp = jnp.asarray(x4[:, 3])
    err = rel_l2(spmv_planes(tuple(s_offs), s32[None], xp),
                 spmv_dia(tuple(s_offs), s32, xp))
    log(f"kernels sub-block S_hat (1x1) f32 rel_l2={err:.3e} "
        f"(tol {F32_TOL:g})")
    assert err <= F32_TOL, err


# -- phases 3-5: the transient solver ----------------------------------------


@contextlib.contextmanager
def timed_steps(record):
    """Time each NavierStokesSolver.step call to completion; append
    (solver, seconds, stats) to `record`."""
    from navierstokes_tpu.model import NavierStokesSolver

    orig = NavierStokesSolver.step

    def step(self, u, u_old, delta_u):
        t0 = time.perf_counter()
        out = orig(self, u, u_old, delta_u)
        out[0].block_until_ready()
        record.append((self, time.perf_counter() - t0, out[2]))
        return out

    NavierStokesSolver.step = step
    try:
        yield
    finally:
        NavierStokesSolver.step = orig


def check_physics(solver, u, label):
    mesh = solver.disc.mesh
    u = np.asarray(u)
    assert np.all(np.isfinite(u)), f"{label}: non-finite state"
    u4 = u.reshape(mesh.nv, 4)
    tags = mesh.node_tags
    y, z = mesh.coords[:, 1], mesh.coords[:, 2]
    inlet = tags == 2
    prof = ((1.0 - y[inlet] ** 2) * (1.0 - z[inlet] ** 2)).astype(u.dtype)
    assert np.array_equal(u4[inlet, 0], prof), f"{label}: inlet profile"
    assert not np.any(u4[tags == 1, :3]), f"{label}: obstacle velocity"
    log(f"{label}: physics ok — inlet u_x exact on {int(inlet.sum())} "
        f"nodes, obstacle velocity 0 on {int((tags == 1).sum())} nodes")


def check_dat(out_dir, n_steps, ndof):
    from navierstokes_tpu.io.dat import HEADER, read_petsc_vec

    for k in range(1, n_steps + 1):
        path = os.path.join(out_dir, f"solution_step{k:04d}.dat")
        with open(path) as f:
            head = f.read(len(HEADER))
        assert head == HEADER, (path, head)
    vals = read_petsc_vec(path)
    assert vals.shape == (ndof,) and np.all(np.isfinite(vals)), path


def phase_run(matrix_id, n_steps, expect, out_dir):
    """run.main at `matrix_id` with --save; returns (solver, u)."""
    from navierstokes_tpu import run
    from navierstokes_tpu.utils.profiling import event_log

    record = []
    before = event_log.totals()
    t0 = time.perf_counter()
    with timed_steps(record):
        u = run.main(["--matrix-id", str(matrix_id), "--steps", str(n_steps),
                      "--save", "--save-dir", out_dir])
    wall = time.perf_counter() - t0
    tot = {k: v - before.get(k, 0.0) for k, v in event_log.totals().items()}
    solver = record[0][0]
    label = f"m{matrix_id}"
    kr = solver.cfg.krylov
    for key, val in expect.items():
        assert getattr(kr, key) == val, (label, key, getattr(kr, key), val)
    for k, (_, _, st) in enumerate(record, 1):
        assert bool(st.converged), f"{label}: step {k} Newton not converged"
    check_physics(solver, u, label)
    check_dat(out_dir, n_steps, solver.disc.ndof)
    times = [t for _, t, _ in record]
    steady = times[1:]
    newton = [int(st.iters) for _, _, st in record]
    lin = [int(st.lin_iters) for _, _, st in record]
    log(f"{label}: rows={solver.disc.ndof} precond={kr.preconditioner} "
        f"coarse_agg={kr.coarse_agg} coarse_cheby={kr.coarse_cheby} "
        f"schur_v_cheby={kr.schur_v_cheby}")
    log(f"{label}: setup_s={tot.get('setup', 0.0):.2f} "
        f"stokes_s={tot.get('stokes_init', 0.0):.2f} "
        f"first_step_s={times[0]:.2f} "
        f"median_ms_per_step={1e3 * statistics.median(steady):.2f} "
        f"(steps 2-{n_steps}: "
        + " ".join(f"{1e3 * t:.2f}" for t in steady) + ") "
        f"wall_s={wall:.1f}")
    log(f"{label}: newton/step={newton} lin/step={lin}")
    return solver, u


def phase_f64(u32, matrix_id, n_steps):
    import dataclasses

    from navierstokes_tpu.config import NewtonConfig, NSConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.run import default_f32_krylov

    kr = dataclasses.replace(default_f32_krylov(), rtol=1e-10, atol=1e-12,
                             maxiter=2000)
    cfg = NSConfig(dtype="float64", newton=NewtonConfig(), krylov=kr,
                   stokes_krylov=dataclasses.replace(kr, rtol=1e-12))
    with x64(True):
        t0 = time.perf_counter()
        s = NavierStokesSolver(scaling_series_mesh(matrix_id), cfg)
        record = []
        with timed_steps(record):
            u64 = np.asarray(s.run(n_steps, monitor=False))
        assert all(bool(st.converged) for _, _, st in record)
        check_physics(s, u64, f"m{matrix_id} f64")
        drift = rel_l2(np.asarray(u32, np.float64), u64)
        log(f"m{matrix_id} f64: precond={s.cfg.krylov.preconditioner} "
            f"coarse_cheby={s.cfg.krylov.coarse_cheby} "
            f"newton/step={[int(st.iters) for _, _, st in record]} "
            f"lin/step={[int(st.lin_iters) for _, _, st in record]} "
            f"wall_s={time.perf_counter() - t0:.1f}")
        log(f"m{matrix_id} f32 vs f64 after {n_steps} steps: rel_l2 drift="
            f"{drift:.3e} (tol {DRIFT_TOL:g})")
        assert drift < DRIFT_TOL, drift
        del s


# -- --four: distributed ------------------------------------------------------


def phase_four(devices, parity_id=6, steps_id=8, n_steps=3):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.config import NewtonConfig, NSConfig, SolverConfig
    from navierstokes_tpu.mesh.box import scaling_series_mesh
    from navierstokes_tpu.mesh.ordering import reorder_mesh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.parallel import DistributedNavierStokesSolver
    from navierstokes_tpu.run import default_f32_krylov

    ndev = len(devices)

    def spread(tree, label):
        for leaf in jax.tree_util.tree_leaves(tree):
            if isinstance(leaf, jax.Array) and leaf.size > 1:
                assert len(leaf.sharding.device_set) == ndev, (
                    label, leaf.shape, leaf.sharding)

    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", spmv="plane")
    cfg = NSConfig(
        dtype="float64",
        newton=NewtonConfig(rtol=1e-10, atol=1e-12, stol=1e-13, max_iter=10,
                            du_tol=float("inf")),
        krylov=kr, stokes_krylov=kr,
    )
    with x64(True):
        mesh = scaling_series_mesh(parity_id)
        t0 = time.perf_counter()
        dist, perm = DistributedNavierStokesSolver.from_mesh(
            mesh, cfg, devices=devices)
        single = NavierStokesSolver(reorder_mesh(mesh, perm), cfg)
        u0 = single.stokes_init()
        us, _, ss = single.step(u0, u0, jnp.zeros_like(u0))
        ud, _, sd = dist.step(u0, u0, jnp.zeros_like(u0))
        ud.block_until_ready()
        spread(dist._step_consts, "step operands")
        spread(ud, "step output")
        err = rel_l2(ud, us)
        nd, ns = int(sd.iters), int(ss.iters)
        ld, ls = int(sd.lin_iters), int(ss.lin_iters)
        log(f"four m{parity_id} f64: {ndev} devices vs 1 rel_err={err:.3e} "
            f"newton={nd} (single {ns}) lin={ld} (single {ls}) "
            f"shard_spmv={dist.shard_kernel_name()} "
            f"wall_s={time.perf_counter() - t0:.1f}")
        assert err < 1e-8, err
        assert nd == ns and abs(ld - ls) <= 2, (nd, ns, ld, ls)
        del dist, single

    kr32 = default_f32_krylov()
    cfg32 = NSConfig(
        newton=NewtonConfig(rtol=1e-4, atol=1e-5, stol=1e-6,
                            du_tol=float("inf")),
        krylov=kr32, stokes_krylov=kr32,
    )
    t0 = time.perf_counter()
    dist, _ = DistributedNavierStokesSolver.from_mesh(
        scaling_series_mesh(steps_id), cfg32, devices=devices)
    setup = time.perf_counter() - t0
    u = dist.stokes_init()
    u.block_until_ready()
    record = []
    with timed_steps(record):
        du = jnp.zeros_like(u)
        for _ in range(n_steps + 1):
            u, du, st = dist.step(u, u, du)
    assert all(bool(st.converged) for _, _, st in record)
    spread(dist._step_consts, "m8 step operands")
    check_physics(dist, u, f"four m{steps_id} f32")
    times = [t for _, t, _ in record]
    log(f"four m{steps_id} f32: {ndev} devices rows={dist.disc.ndof} "
        f"precond={dist.cfg.krylov.preconditioner} setup_s={setup:.1f} "
        f"first_step_s={times[0]:.2f} median_ms_per_step="
        f"{1e3 * statistics.median(times[1:]):.2f} "
        f"newton/step={[int(s.iters) for _, _, s in record]} "
        f"lin/step={[int(s.lin_iters) for _, _, s in record]}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run the 4-GPU distributed phase and nothing else")
    args = p.parse_args(argv)

    import jax

    from navierstokes_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devices = check_device(jax)
    log(f"device: {devices[0].device_kind} x{len(devices)} "
        f"(platform {devices[0].platform})")
    log(nvidia_smi())
    log(f"compile cache: {cache}")

    if args.four:
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phase_four(devices)
    else:
        devices = devices[:1]
        phase_kernels()
        with tempfile.TemporaryDirectory() as out:
            _, u6 = phase_run(6, 6, {"preconditioner": "two_level",
                                     "coarse_cheby": 3},
                              os.path.join(out, "m6"))
            phase_f64(u6, 6, 6)
            phase_run(8, 4, {"preconditioner": "schur",
                             "schur_v_cheby": 2}, os.path.join(out, "m8"))
    print(contract_line(devices), flush=True)


if __name__ == "__main__":
    sys.exit(main())
