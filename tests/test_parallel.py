"""Multi-chip partitioned operator: multi-device == single-device equivalence
(the test the reference never had — SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh

from navierstokes_tpu.config import NSConfig, SolverConfig
from navierstokes_tpu.fem.assembly import (
    LINEAR_TERMS,
    assemble_operator,
    build_discretization,
)
from navierstokes_tpu.fem.dirichlet import zero_rows_bcsr
from navierstokes_tpu.mesh import channel_mesh
from navierstokes_tpu.model import NavierStokesSolver
from navierstokes_tpu.ops.spmv import spmv_bell
from navierstokes_tpu.parallel import (
    DistributedNavierStokesSolver,
    build_row_partition,
    partitioned_spmv,
)
from navierstokes_tpu.parallel.partitioned import (
    pad_ell_values,
    pad_vector,
    partitioned_spmv_power,
    unpad_vector,
)
from navierstokes_tpu.sparse.bcsr import BCSR4
from navierstokes_tpu.sparse.bell import bell_from_bcsr

N_DEV = 8


@pytest.fixture(scope="module")
def device_mesh():
    devs = jax.devices()
    assert len(devs) >= N_DEV, "conftest must provide 8 virtual CPU devices"
    return DeviceMesh(np.array(devs[:N_DEV]), ("x",))


@pytest.fixture(scope="module")
def banded_operator():
    """BC-applied linear FEM operator on a long band-ordered channel."""
    mesh = channel_mesh(48, 2, 2, length=8.0)  # long & thin: small bandwidth
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    values = zero_rows_bcsr(
        op.values, disc.row_ids, jnp.asarray(disc.indices), disc.diag_slots,
        disc.bc.row_bc,
    )
    op = BCSR4(indptr=op.indptr, indices=op.indices, values=values)
    return disc, op


def test_partitioned_spmv_matches_single(device_mesh, banded_operator):
    disc, op = banded_operator
    ell = bell_from_bcsr(op)
    part = build_row_partition(ell.indices, N_DEV)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(4 * ell.nb))
    y_single = spmv_bell(jnp.asarray(ell.indices), ell.values, x)

    vals_pad = pad_ell_values(part, ell.values)
    xp = pad_vector(part, x)
    y_multi = partitioned_spmv(
        part, device_mesh, "x", jnp.asarray(part.delta_indices), vals_pad, xp
    )
    np.testing.assert_allclose(
        np.asarray(unpad_vector(part, y_multi)), np.asarray(y_single),
        rtol=1e-13, atol=1e-13,
    )
    # padding rows act as identity
    tail = np.asarray(y_multi)[4 * part.nb:]
    np.testing.assert_allclose(tail, np.asarray(xp)[4 * part.nb:])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_partitioned_matrix_powers(device_mesh, banded_operator, k):
    """CA A^k x (one deep exchange) == k chained SpMVs — the fused-vs-chained
    identity of `mpk/SpMVmulti0.cpp:365-416`, on 8 devices."""
    disc, op = banded_operator
    ell = bell_from_bcsr(op)
    part = build_row_partition(ell.indices, N_DEV)
    if k * part.halo > part.rows_per_dev:
        pytest.skip("mesh too small for this k at 8 devices")

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(4 * ell.nb))

    y_ref = x
    for _ in range(k):
        y_ref = spmv_bell(jnp.asarray(ell.indices), ell.values, y_ref)

    vals_pad = pad_ell_values(part, ell.values)
    y_ca = partitioned_spmv_power(
        part, device_mesh, "x", jnp.asarray(part.delta_indices), vals_pad,
        pad_vector(part, x), k,
    )
    rel = np.linalg.norm(
        np.asarray(unpad_vector(part, y_ca)) - np.asarray(y_ref)
    ) / np.linalg.norm(np.asarray(y_ref))
    assert rel < 1e-12, f"fused A^{k}x relative error {rel}"


def test_distributed_solver_matches_single_chip():
    """Full transient step on 8 devices == single chip (tolerance-level)."""
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000),
        stokes_krylov=SolverConfig(rtol=1e-13, atol=1e-13, maxiter=4000),
    )
    mesh = channel_mesh(12, 2, 2, length=6.0)

    single = NavierStokesSolver(mesh, cfg)
    u_single = single.run(2, monitor=False)

    dist, perm = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    u_dist = dist.run(2, monitor=False)

    # identical node ordering (generator mesh is already band-ordered)
    np.testing.assert_array_equal(perm, np.arange(mesh.nv))
    err = np.linalg.norm(np.asarray(u_dist) - np.asarray(u_single)) / (
        np.linalg.norm(np.asarray(u_single))
    )
    assert err < 1e-8, f"multi-chip vs single-chip relative error {err}"


def test_partitioned_dia_spmv_and_powers(device_mesh, banded_operator):
    """Partitioned scalar-DIA SpMV and one-exchange power stack vs chained."""
    from navierstokes_tpu.ops.spmv import spmv_dia
    from navierstokes_tpu.parallel.partitioned import (
        partitioned_spmv_dia,
        partitioned_spmv_dia_power,
    )
    from navierstokes_tpu.sparse.dia import dia_from_bcsr

    disc, op = banded_operator
    dia = dia_from_bcsr(op)
    n = disc.ndof
    h = dia.halo
    L = max(-(-n // N_DEV), h)
    n_pad = N_DEV * L
    data_p = jnp.pad(dia.data, ((0, 0), (0, n_pad - n)))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(n))
    xp = jnp.pad(x, (0, n_pad - n))

    y_ref = spmv_dia(dia.offsets, dia.data, x)
    y = partitioned_spmv_dia(device_mesh, "x", dia.offsets, data_p, xp, N_DEV)
    np.testing.assert_allclose(np.asarray(y[:n]), np.asarray(y_ref),
                               rtol=1e-12, atol=1e-12)

    k = min(3, L // h)
    if k >= 2:
        stack = partitioned_spmv_dia_power(
            device_mesh, "x", dia.offsets, data_p, xp, N_DEV, k,
            return_all=True,
        )
        cur = x
        for j in range(k):
            cur = spmv_dia(dia.offsets, dia.data, cur)
            rel = np.linalg.norm(np.asarray(stack[:n, j]) - np.asarray(cur)) / (
                np.linalg.norm(np.asarray(cur))
            )
            assert rel < 1e-12, f"power {j + 1} rel err {rel}"


def test_distributed_ca_gmres(device_mesh, banded_operator):
    """s-step GMRES with the one-exchange power basis solves the system."""
    from navierstokes_tpu.ops.block import block4_inverse
    from navierstokes_tpu.ops.spmv import spmv_dia
    from navierstokes_tpu.parallel.partitioned import (
        partitioned_spmv_dia,
        partitioned_spmv_dia_power,
    )
    from navierstokes_tpu.solvers.sstep import ca_gmres
    from navierstokes_tpu.sparse.dia import (
        block_diag_to_dia,
        dia_from_bcsr,
        dia_values_from_bcsr_values,
        scale_rows_dia,
    )

    disc, op = banded_operator
    pat = disc.dia_pattern
    data = dia_values_from_bcsr_values(pat, op.values,
                                       flat_map_dev=disc.dia_flat_map)
    inv = block4_inverse(op.values[disc.diag_slots], pivot_eps=1e-300)
    s_off, s_data = scale_rows_dia(pat, data, inv)
    invd = block_diag_to_dia(inv)

    n = disc.ndof
    h = max(max(abs(d) for d in s_off), 1)
    basis = 8
    L = max(-(-n // N_DEV), basis * h)
    n_pad = N_DEV * L
    s_data_p = jnp.pad(s_data, ((0, 0), (0, n_pad - n)))
    b = spmv_dia(invd.offsets, invd.data, disc.bc.value)
    b_p = jnp.pad(b, (0, n_pad - n))

    def matvec(x):
        return partitioned_spmv_dia(device_mesh, "x", s_off, s_data_p, x,
                                    N_DEV)

    def powers_fn(v, s):
        return partitioned_spmv_dia_power(
            device_mesh, "x", s_off, s_data_p, v, N_DEV, s, return_all=True
        )

    res = ca_gmres(matvec, b_p, basis=basis, rtol=1e-10, atol=1e-12,
                   maxiter=4000, powers_fn=powers_fn)
    assert bool(res.converged)
    x_ref = np.linalg.solve(op.to_dense(), np.asarray(disc.bc.value))
    err = np.linalg.norm(np.asarray(res.x[:n]) - x_ref) / np.linalg.norm(x_ref)
    assert err < 1e-6, f"distributed ca-gmres error {err}"


def test_distributed_solver_ca_gmres_method():
    """Distributed solver with method='ca_gmres' (one-exchange basis) matches
    the standard-GMRES distributed solve."""
    import dataclasses

    cfg = NSConfig(
        dt=0.01, t_final=0.01, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=SolverConfig(rtol=1e-11, atol=1e-12, maxiter=6000,
                            neumann_order=0),
        stokes_krylov=SolverConfig(rtol=1e-12, atol=1e-12, maxiter=6000,
                                   neumann_order=0),
    )
    cfg_ca = dataclasses.replace(
        cfg,
        krylov=dataclasses.replace(cfg.krylov, method="ca_gmres", restart=8),
        stokes_krylov=dataclasses.replace(cfg.stokes_krylov,
                                          method="ca_gmres", restart=8),
    )
    mesh = channel_mesh(24, 2, 2, length=6.0)
    devs = jax.devices()[:4]
    s_std, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg, devices=devs)
    s_ca, _ = DistributedNavierStokesSolver.from_mesh(mesh, cfg_ca,
                                                      devices=devs)
    u0 = s_std.stokes_init()
    import jax.numpy as jnp_

    u1, _, st1 = s_std.step(u0, u0, jnp_.zeros_like(u0))
    u2, _, st2 = s_ca.step(u0, u0, jnp_.zeros_like(u0))
    assert bool(st1.converged) and bool(st2.converged)
    err = np.linalg.norm(np.asarray(u2) - np.asarray(u1)) / np.linalg.norm(
        np.asarray(u1)
    )
    assert err < 1e-6, f"distributed ca_gmres drift {err}"


def _plane_spmv_check(devices, disc, op, rtol):
    """partitioned_spmv_plane on `devices` (whole aggregates and at least
    one halo per device) == the single-device scalar-DIA product."""
    from navierstokes_tpu.ops.plane_dia import (
        extract_planes,
        from_planes,
        node_offsets_from_scalar,
        plane_halo,
        to_planes,
    )
    from navierstokes_tpu.ops.spmv import spmv_dia
    from navierstokes_tpu.parallel.partitioned import partitioned_spmv_plane
    from navierstokes_tpu.sparse.dia import dia_from_bcsr

    dia = dia_from_bcsr(op)
    n = disc.ndof
    nb = n // 4
    ndev = len(devices)
    x = jnp.asarray(np.random.default_rng(11).standard_normal(n))
    y_ref = spmv_dia(dia.offsets, dia.data, x)

    noffs = node_offsets_from_scalar(dia.offsets)
    agg = 4
    Lb = -(-max(-(-nb // ndev), plane_halo(noffs)) // agg) * agg
    nbp = ndev * Lb
    planes = extract_planes(dia.offsets, dia.data, nb, node_offsets=noffs,
                            nbp=nbp)
    dmesh = DeviceMesh(np.array(devices), ("x",))
    y_pl = from_planes(
        partitioned_spmv_plane(dmesh, "x", noffs, planes,
                               to_planes(x, nb, nbp), ndev),
        nb, nbp,
    )
    np.testing.assert_allclose(np.asarray(y_pl), np.asarray(y_ref),
                               rtol=rtol, atol=rtol)


def test_partitioned_pretiled_and_plane_spmv_match(device_mesh,
                                                   banded_operator):
    """Per-shard SpMVs == single-chip XLA DIA: the scalar-DIA shifted
    multiply-adds and the component-plane SpMV, each behind one ppermute
    halo exchange (the kernel-injection seam — the reference injects AVX2
    into every operator it owns, `src/solve_newton.c:864-879`)."""
    from navierstokes_tpu.ops.spmv import spmv_dia
    from navierstokes_tpu.parallel.partitioned import partitioned_spmv_dia
    from navierstokes_tpu.sparse.dia import dia_from_bcsr

    disc, op = banded_operator
    dia = dia_from_bcsr(op)
    n = disc.ndof
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal(n))
    y_ref = spmv_dia(dia.offsets, dia.data, x)

    L = max(-(-n // N_DEV), dia.halo)
    n_pad = N_DEV * L
    y = partitioned_spmv_dia(
        device_mesh, "x", dia.offsets,
        jnp.pad(dia.data, ((0, 0), (0, n_pad - n))),
        jnp.pad(x, (0, n_pad - n)), N_DEV,
    )
    np.testing.assert_allclose(np.asarray(y[:n]), np.asarray(y_ref),
                               rtol=1e-13, atol=1e-13)
    _plane_spmv_check(jax.devices()[:N_DEV], disc, op, 1e-13)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_partitioned_plane_spmv_device_counts(banded_operator, ndev):
    """The distributed plane SpMV == single device on 2, 4 and 8 virtual
    devices (one, a few and many halo neighbours per shard)."""
    disc, op = banded_operator
    _plane_spmv_check(jax.devices()[:ndev], disc, op, 1e-13)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_plane_layout(ndev):
    """Distributed plane layout: equal node counts per device, whole
    aggregates per device, at least one halo per device, minimal padding."""
    kr = SolverConfig(preconditioner="two_level", coarse_agg=4,
                      spmv="plane")
    cfg = NSConfig(dtype="float64", krylov=kr, stokes_krylov=kr)
    dist, _ = DistributedNavierStokesSolver.from_mesh(
        channel_mesh(48, 2, 2, length=8.0), cfg, devices=jax.devices()[:ndev]
    )
    noffs = (-9, -1, 0, 1, 9)
    nb = dist.disc.mesh.nv
    nbp = dist._plane_layout(nb, noffs)
    Lb = nbp // ndev
    assert nbp % ndev == 0 and Lb % 4 == 0 and Lb >= 9
    assert nbp >= nb and Lb - 4 < max(-(-nb // ndev), 9)
    assert dist.shard_kernel_name() == "plane_xla"


@pytest.mark.slow
@pytest.mark.parametrize("spmv,kernel", [("xla", "dia_xla"),
                                         ("plane", "plane_xla")])
def test_distributed_flagship_kernels_match_single_chip(spmv, kernel):
    """Full distributed transient step with the per-shard SpMVs (scalar-DIA
    / component-plane) == single chip, and the external contract names the
    shard SpMV (dryrun prints it)."""
    import dataclasses

    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4, spmv=spmv)
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=kr,
        stokes_krylov=dataclasses.replace(kr, rtol=1e-13),
    )
    mesh = channel_mesh(12, 2, 2, length=6.0)

    single = NavierStokesSolver(mesh, cfg)
    u_single = single.run(1, monitor=False)

    dist, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    assert dist.shard_kernel_name() == kernel
    u_dist = dist.run(1, monitor=False)
    err = np.linalg.norm(np.asarray(u_dist) - np.asarray(u_single)) / (
        np.linalg.norm(np.asarray(u_single))
    )
    assert err < 1e-8, f"{spmv} multi-chip vs single-chip error {err}"


@pytest.mark.slow
def test_flagship_kernels_multitile_shards(device_mesh):
    """Per-shard plane SpMV at a realistic shape: a ~10k-node channel gives
    every device ~1232 nodes, far wider than the node halo, so interior
    and edge shards both carry real data."""
    mesh = channel_mesh(200, 6, 6, length=16.0)   # 9849 nodes, 39396 DoF
    disc = build_discretization(mesh, dtype=jnp.float64)
    op = assemble_operator(disc, jnp.zeros(disc.ndof), 0.01, 50.0, 0.1,
                           LINEAR_TERMS)
    op = BCSR4(indptr=op.indptr, indices=op.indices,
               values=zero_rows_bcsr(
                   op.values, disc.row_ids, jnp.asarray(disc.indices),
                   disc.diag_slots, disc.bc.row_bc))
    _plane_spmv_check(jax.devices()[:N_DEV], disc, op, 1e-12)


def test_partition_rejects_wide_band(device_mesh):
    mesh = channel_mesh(2, 2, 2)  # tiny: bandwidth ~ nv
    disc = build_discretization(mesh, dtype=jnp.float64)
    with pytest.raises(ValueError, match="halo|bandwidth"):
        build_row_partition(disc.ell_indices, 16)


def test_distributed_two_level_matches_single_chip():
    """Distributed two-level preconditioned solve == single chip: the coarse
    correction is local restrict + one tiny all_gather + row-sharded dense
    GEMV + local prolong (aggregates never straddle devices)."""
    import dataclasses

    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4)
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=kr,
        stokes_krylov=dataclasses.replace(kr, rtol=1e-13),
    )
    mesh = channel_mesh(12, 2, 2, length=6.0)

    single = NavierStokesSolver(mesh, cfg)
    u_single = single.run(2, monitor=False)

    dist, perm = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    u_dist = dist.run(2, monitor=False)

    np.testing.assert_array_equal(perm, np.arange(mesh.nv))
    err = np.linalg.norm(np.asarray(u_dist) - np.asarray(u_single)) / (
        np.linalg.norm(np.asarray(u_single))
    )
    assert err < 1e-8, f"two-level multi-chip vs single-chip error {err}"


def test_distributed_multilevel_coarse_matches_single_chip():
    """Distributed MULTILEVEL two-level (sparse coarse + dense second level,
    forced via coarse_dense_max) == single chip: the coarse cycle runs
    replicated per device off one tiny all_gather."""
    import dataclasses

    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4,
                      coarse_dense_max=32)
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=kr,
        stokes_krylov=dataclasses.replace(kr, rtol=1e-13),
    )
    mesh = channel_mesh(12, 2, 2, length=6.0)

    single = NavierStokesSolver(mesh, cfg)
    assert single._exact_prep[6][0] == "ml"
    u_single = single.run(2, monitor=False)

    dist, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    u_dist = dist.run(2, monitor=False)

    err = np.linalg.norm(np.asarray(u_dist) - np.asarray(u_single)) / (
        np.linalg.norm(np.asarray(u_single))
    )
    assert err < 1e-8, f"multilevel multi-chip vs single-chip error {err}"


def test_partitioned_assembly_matches_global():
    """Sharded setup: per-shard element assembly == global assembly.

    Each device scatters only the elements whose rows it owns (one
    right-neighbor ppermute completes the halo sum), so setup cost no
    longer replicates per device."""
    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import (
        FULL_JACOBIAN_TERMS,
        LINEAR_TERMS,
        local_fields,
    )

    cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64")
    mesh = channel_mesh(12, 2, 2, length=6.0)
    single = NavierStokesSolver(mesh, cfg)
    dist, perm = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    np.testing.assert_array_equal(perm, np.arange(mesh.nv))

    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal(single.disc.ndof))
    UL, _ = local_fields(single.disc.tets, u)
    for terms in (LINEAR_TERMS, FULL_JACOBIAN_TERMS):
        ref = np.asarray(single._assemble_dia(UL, terms))
        got = np.asarray(dist._assemble_dia(UL, terms))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_partitioned_assembly_chunked_matches_global():
    """The chunked per-shard element loop (taken when a device owns more
    elements than one chunk, as at m6 on four devices) == global assembly."""
    import jax.numpy as jnp

    from navierstokes_tpu.fem.assembly import LINEAR_TERMS
    from navierstokes_tpu.parallel.partitioned import (
        partitioned_assemble_dia,
    )

    cfg = NSConfig(dt=0.01, reynolds=100.0, delta=0.1, dtype="float64")
    mesh = channel_mesh(12, 2, 2, length=6.0)
    single = NavierStokesSolver(mesh, cfg)
    dist, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:4]
    )
    ep, arr = dist._ensure_epart(), dist._ep_arrays
    assert ep.e_max > 16, ep.e_max
    UL = jnp.zeros((single.disc.ne, 3, 4))
    got = partitioned_assemble_dia(
        ep, dist.device_mesh, dist.axis, arr["ep_grad"], arr["ep_vol"],
        arr["ep_h"], UL[arr["ep_perm"]], arr["ep_map"], cfg.dt,
        cfg.reynolds, cfg.delta, terms=LINEAR_TERMS, chunk=16,
    )[:, : single.disc.ndof]
    ref = single._assemble_dia(UL, LINEAR_TERMS)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_multilevel_coarse_smooth_cycles():
    """Stronger multilevel coarse cycles (extra smoothing sweeps / cycles)
    converge to the same solution with no more outer iterations, on one
    chip and distributed."""
    import dataclasses

    kr = SolverConfig(rtol=1e-12, atol=1e-13, maxiter=4000,
                      preconditioner="two_level", coarse_agg=4,
                      coarse_dense_max=32,
                      coarse_ml_smooth=2, coarse_ml_cycles=2)
    cfg = NSConfig(
        dt=0.01, t_final=0.02, reynolds=100.0, delta=0.1, dtype="float64",
        krylov=kr,
        stokes_krylov=dataclasses.replace(kr, rtol=1e-13),
    )
    mesh = channel_mesh(12, 2, 2, length=6.0)

    single = NavierStokesSolver(mesh, cfg)
    assert single._exact_prep[6][0] == "ml"
    u_single = single.run(2, monitor=False)

    base_cfg = dataclasses.replace(
        cfg,
        krylov=dataclasses.replace(kr, coarse_ml_smooth=1,
                                   coarse_ml_cycles=1),
    )
    u_base = NavierStokesSolver(mesh, base_cfg).run(2, monitor=False)
    err0 = np.linalg.norm(np.asarray(u_single) - np.asarray(u_base)) / (
        np.linalg.norm(np.asarray(u_base))
    )
    assert err0 < 1e-8, f"strong vs default ml coarse solution drift {err0}"

    dist, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:N_DEV]
    )
    u_dist = dist.run(2, monitor=False)
    err = np.linalg.norm(np.asarray(u_dist) - np.asarray(u_single)) / (
        np.linalg.norm(np.asarray(u_single))
    )
    assert err < 1e-8, f"multilevel multi-chip vs single-chip error {err}"
