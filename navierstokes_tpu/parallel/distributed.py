"""Multi-chip Navier–Stokes solver: domain decomposition over a device mesh.

Extends the single-chip `NavierStokesSolver` by routing every Krylov matvec
through a partitioned SpMV (`parallel.partitioned`): vectors are padded and
row-sharded over the mesh axis, each matvec does one bidirectional
`ppermute` halo exchange of max|offset| boundary scalars, and the GMRES
dots/norms on the sharded vectors are partitioned by XLA into local
reductions + psum.  Both the per-iteration ("reference" Jacobian) and the
precomputed ("exact") solve paths inherit this automatically through
`_solve_prepared`.

Each shard runs the same SpMV as the single-device solver: the scalar-DIA
shifted multiply-adds (`partitioned_spmv_dia`), or with spmv='plane' the
component-plane SpMV, with the whole Krylov space kept in the plane layout,
node-partitioned, behind a per-plane halo exchange
(`partitioned_spmv_plane`, `_solve_prepared_tlp`).  This is the
kernel-injection seam applied to the distributed operator too — the
reference injects its AVX2 MatMult into every operator it owns
(`src/solve_newton.c:864-879`).

The mesh must be band-ordered (RCM) so the scalar bandwidth fits in a
per-device chunk — `from_mesh` handles ordering and validates the fit.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P

from navierstokes_tpu.config import NSConfig
from navierstokes_tpu.mesh.core import Mesh
from navierstokes_tpu.mesh.ordering import best_ordering, reorder_mesh
from navierstokes_tpu.model.navier_stokes import (
    NavierStokesSolver,
    _merge_prep,
)
from navierstokes_tpu.parallel.partitioned import (
    partitioned_spmv_dia,
    partitioned_spmv_plane,
)
from navierstokes_tpu.solvers.gmres import GMRESResult, gmres


class DistributedNavierStokesSolver(NavierStokesSolver):
    # Krylov recycling keeps its (k, n) GEMVs unsharded — single-chip only
    # until they are (model._build_deflation raises a clear error).
    _supports_deflation = False
    # Chebyshev post-smoothing: the distributed tl/tlp solve paths build
    # their own minv with exact-arity tuple unpacks — single-chip only
    # (model._maybe_append_cheby raises a clear error).
    _supports_cheby = False
    # preconditioner="auto" resolves to plain two_level here (schur and
    # coarse_cheby are single-chip; resolve_coarse_defaults degrades by
    # design — an EXPLICIT schur still raises below).
    _auto_single_chip = False

    def __init__(
        self,
        mesh: Mesh,
        cfg: Optional[NSConfig] = None,
        *,
        devices=None,
        axis: str = "x",
    ):
        if cfg is not None and cfg.krylov.preconditioner == "schur":
            raise ValueError(
                "preconditioner='schur' is single-chip only (its sub-block "
                "plane applies are not sharded); use 'two_level'"
            )
        devices = list(devices if devices is not None else jax.devices())
        self.axis = axis
        self.n_devices = len(devices)
        self.device_mesh = DeviceMesh(np.array(devices), (axis,))
        self._epart = None
        super().__init__(mesh, cfg)
        # Sharded-setup element arrays ride the consts pytree into the
        # jitted step/stokes functions (never closure captures).
        self._ensure_epart()
        self._consts.update(self._ep_arrays)

        # Validate the band fits: scalar halo <= rows per device.
        halo = max(abs(d) for d in self.disc.dia_pattern.scaled_offsets)
        n = self.disc.ndof
        L = -(-n // self.n_devices)
        if halo > L:
            raise ValueError(
                f"scalar bandwidth {halo} exceeds rows-per-device {L}; "
                "reduce device count or refine/reorder the mesh"
            )

    # -- distributed kernel layouts ------------------------------------------

    def _plane_layout(self, nb: int, node_offsets: tuple) -> int:
        """Padded node count nbp for the distributed component-plane layout:
        every device holds the same number of nodes, whole aggregates, and
        a node slice at least as wide as the halo."""
        h = max(max(abs(d) for d in node_offsets), 1)
        agg = self.cfg.krylov.coarse_agg
        need = max(-(-nb // self.n_devices), h)    # minimal nodes-per-device
        return self.n_devices * (-(-need // agg) * agg)

    def _ensure_prepared(self):
        """Prepare as the single-device solver does, then place every step
        operand on the device mesh: component-plane arrays (last axis = the
        padded node count) sharded along the nodes, everything else
        replicated — no step operand stays on one device, so the step moves
        no operator bytes between devices."""
        if self._prepared:
            return
        super()._ensure_prepared()
        prep = self._exact_prep_val if self.cfg.jacobian == "exact" else None
        nbp = prep[7] if prep is not None and prep[0] == "tlp" else None
        ndev = self.n_devices

        def place(a):
            if not isinstance(a, jax.Array) or \
                    len(a.sharding.device_set) == ndev:
                return a
            if nbp is not None and a.ndim and a.shape[-1] == nbp:
                spec = P(*([None] * (a.ndim - 1)), self.axis)
            else:
                spec = P()
            return jax.device_put(a, NamedSharding(self.device_mesh, spec))

        for key in self._step_consts:
            self._consts[key] = jax.tree_util.tree_map(place,
                                                       self._consts[key])
        if prep is not None:
            self._exact_prep_val = _merge_prep(self._prep_static,
                                               self._consts["prep"])
        if "res_A" in self._consts:
            self._res_A = self._consts["res_A"]
            self._res_M = self._consts["res_M"]

    def _prepare_operator_dia(self, dia_data):
        if self._plane_mode() and self.cfg.krylov.coarse_basis == "linear":
            raise ValueError(
                "coarse_basis='linear' is single-chip only (its weighted "
                "restriction is not implemented per shard)"
            )
        return super()._prepare_operator_dia(dia_data)

    # -- sharded setup: assembly in the partitioned view --------------------
    #
    # Round-1 weakness (PARITY.md): assembly and operator preparation ran in
    # the global view, replicated per device.  Element integration + scatter
    # (the heavy setup cost) now runs shard_map'd over per-shard element
    # ranges — each device assembles only the elements whose rows it owns,
    # and one right-neighbor ppermute of the halo columns completes the sum.

    def _ensure_epart(self):
        if self._epart is None:
            from navierstokes_tpu.parallel.partitioned import (
                build_element_partition,
            )

            d = self.disc
            halo = max(max(abs(o) for o in d.dia_pattern.offsets), 1)
            ep = build_element_partition(
                np.asarray(d.mesh.tets), np.asarray(d.dia_elem_map),
                d.ndof, d.dia_pattern.K, halo, self.n_devices,
            )
            sh = NamedSharding(self.device_mesh, P(self.axis))
            perm = ep.perm
            self._ep_arrays = {
                "ep_grad": jax.device_put(np.asarray(d.grad)[perm], sh),
                "ep_vol": jax.device_put(np.asarray(d.vol)[perm], sh),
                "ep_h": jax.device_put(np.asarray(d.h)[perm], sh),
                "ep_map": jax.device_put(ep.local_map, sh),
                "ep_perm": jax.device_put(perm, sh),
            }
            self._epart = ep
        return self._epart

    def _assemble_partitioned(self, arrays, UL, terms, reynolds):
        from navierstokes_tpu.parallel.partitioned import (
            partitioned_assemble_dia,
        )

        ep = self._ensure_epart()
        data = partitioned_assemble_dia(
            ep, self.device_mesh, self.axis,
            arrays["ep_grad"], arrays["ep_vol"], arrays["ep_h"],
            UL[arrays["ep_perm"]], arrays["ep_map"],
            self.cfg.dt, reynolds, self.cfg.delta, terms=terms,
        )
        return data[:, : self.disc.ndof]

    def _assemble_dia(self, UL, terms):
        self._ensure_epart()
        return self._assemble_partitioned(
            self._ep_arrays, UL, terms, self.cfg.reynolds
        )

    def _assemble_dia_c(self, consts, UL, terms, reynolds):
        return self._assemble_partitioned(consts, UL, terms, reynolds)

    @classmethod
    def from_mesh(cls, mesh: Mesh, cfg=None, *, devices=None, axis="x"):
        """Band-order the mesh, then build the distributed solver."""
        perm = best_ordering(mesh)
        return cls(reorder_mesh(mesh, perm), cfg, devices=devices, axis=axis), perm

    def _pad_n(self, halo: int, multiple: int = 1) -> int:
        n = self.disc.ndof
        P_ = self.n_devices
        L = max(-(-n // P_), halo)
        L = -(-L // multiple) * multiple
        return P_ * L

    def _shard_spmv(self, offsets, data, x):
        """Per-shard scalar-DIA SpMV behind one halo exchange."""
        return partitioned_spmv_dia(self.device_mesh, self.axis, offsets,
                                    data, x, self.n_devices)

    def shard_kernel_name(self) -> str:
        """Which per-shard SpMV the prepared operator dispatches to (the
        contract `dryrun_multichip` prints): "plane_xla" for the
        component-plane layout, "dia_xla" for scalar DIA."""
        self._ensure_prepared()
        prep = self._exact_prep_val if self.cfg.jacobian == "exact" else None
        if prep is None:
            return "dia_xla(per-iteration prep)"
        return "plane_xla" if prep[0] == "tlp" else "dia_xla"

    def _solve_prepared(self, prep, rhs, solver_cfg):
        if prep[0] == "tlp":
            return self._solve_prepared_tlp(prep, rhs, solver_cfg)
        if prep[0] == "tl":
            return self._solve_prepared_tl(prep, rhs, solver_cfg)
        _, s_offsets, s_data, invd_offsets, invd_data = prep
        halo = max(max(abs(d) for d in s_offsets), 1)
        n = self.disc.ndof
        n_pad = self._pad_n(halo)
        pad = n_pad - n

        s_data_p = jnp.pad(s_data, ((0, 0), (0, pad)))
        invd_p = jnp.pad(invd_data, ((0, 0), (0, pad)))
        b = jnp.pad(rhs, (0, pad))
        order = self.cfg.krylov.neumann_order
        dmesh, ax, ndev = self.device_mesh, self.axis, self.n_devices

        def apply_S(x):
            return self._shard_spmv(s_offsets, s_data_p, x)

        def apply_Dinv(x):
            return partitioned_spmv_dia(dmesh, ax, invd_offsets, invd_p, x, ndev)

        def neumann(r):
            acc = r
            cur = r
            for _ in range(order):
                cur = cur - apply_S(cur)
                acc = acc + cur
            return acc

        def matvec(x):
            return neumann(apply_S(x))

        b_eff = neumann(apply_Dinv(b))

        if solver_cfg.method == "ca_gmres" and order == 0:
            # Communication-avoiding s-step GMRES: the whole basis from ONE
            # k*halo-deep exchange (parallel.partitioned_spmv_dia_power).
            from navierstokes_tpu.parallel.partitioned import (
                partitioned_spmv_dia_power,
            )
            from navierstokes_tpu.solvers.sstep import ca_gmres

            basis = min(solver_cfg.restart, 16)
            L = n_pad // ndev
            if basis * halo <= L:
                def powers_fn(v, s):
                    return partitioned_spmv_dia_power(
                        dmesh, ax, s_offsets, s_data_p, v, ndev, s,
                        return_all=True,
                    )

                res = ca_gmres(
                    matvec, b_eff, basis=basis, rtol=solver_cfg.rtol,
                    atol=solver_cfg.atol, maxiter=solver_cfg.maxiter,
                    powers_fn=powers_fn,
                )
                return GMRESResult(
                    x=res.x[:n], iters=res.iters, resnorm=res.resnorm,
                    converged=res.converged,
                )
            # basis too deep for the partition: fall through to gmres

        res = gmres(
            matvec, b_eff, restart=solver_cfg.restart,
            rtol=solver_cfg.rtol, atol=solver_cfg.atol,
            maxiter=solver_cfg.maxiter,
        )
        return GMRESResult(
            x=res.x[:n], iters=res.iters, resnorm=res.resnorm,
            converged=res.converged,
        )

    def _solve_prepared_tl(self, prep, rhs, solver_cfg):
        """Distributed two-level (coarse-grid corrected) solve.

        The coarse space (solvers/coarse): aggregates are contiguous runs of
        `agg` nodes, so with rows-per-device rounded to a multiple of 4*agg
        every aggregate lives wholly on one device and restriction/
        prolongation are LOCAL reshape-reduce/broadcast per shard.  The only
        coarse communication is one tiled all_gather of the (tiny) restricted
        residual per apply; the dense coarse inverse is row-sharded so each
        device computes just its slice of the correction.  Smoothing reuses
        the partitioned DIA SpMV (one halo exchange each for A z and D^-1 r).
        """
        _, a_offsets, a_data, invd_offsets, invd_data, c_arrays, c_static \
            = prep
        cs = c_static[1]
        agg = cs.agg_size
        halo = max(max(abs(d) for d in a_offsets), 1)
        n = self.disc.ndof
        n_pad = self._pad_n(halo, multiple=4 * agg)
        pad = n_pad - n
        dmesh, ax, ndev = self.device_mesh, self.axis, self.n_devices

        a_data_p = jnp.pad(a_data, ((0, 0), (0, pad)))
        invd_p = jnp.pad(invd_data, ((0, 0), (0, pad)))
        b = jnp.pad(rhs, (0, pad))
        # Coarse DoF count over the padded rows; extra (padding) aggregates
        # get zero correction, and the row mask keeps padding rows of z
        # identically zero so padded Krylov iterates stay zero (the
        # invariant the bj path gets for free).
        nc_pad = n_pad // agg
        nc = cs.nc
        mask = (jnp.arange(n_pad) < n).astype(b.dtype)

        def apply_A(x):
            return self._shard_spmv(a_offsets, a_data_p, x)

        def apply_Dinv(x):
            return partitioned_spmv_dia(dmesh, ax, invd_offsets, invd_p, x, ndev)

        if c_static[0] == "dense":
            # Dense coarse inverse, row-sharded: each device computes just
            # its slice of the correction from the all_gathered restriction.
            ac_inv_p = jnp.pad(
                c_arrays[0], ((0, nc_pad - nc), (0, nc_pad - nc))
            )

            from navierstokes_tpu.solvers.coarse import _mix_matrix

            def _coarse_body(r_loc, acinv_loc, mask_loc):
                # local restriction: sum each aggregate, per component —
                # flat-matmul form (no (..., 4)-minor temps: XLA tile-pads
                # those 32x, see solvers/coarse._mix_matrix)
                # HIGHEST: reduced-precision operand rounding damages
                # the coarse correction (see solvers.coarse.restrict)
                hp = jax.lax.Precision.HIGHEST
                mix = _mix_matrix(agg, r_loc.dtype)
                rc_loc = jnp.matmul(r_loc.reshape(-1, 4 * agg), mix,
                                    precision=hp).reshape(-1)
                rc = jax.lax.all_gather(rc_loc, ax, tiled=True)  # (nc_pad,)
                zc_loc = jnp.matmul(acinv_loc, rc, precision=hp)
                z_loc = jnp.matmul(zc_loc.reshape(-1, 4), mix.T,
                                   precision=hp).reshape(-1)
                return z_loc * mask_loc

            coarse_correct = jax.shard_map(
                _coarse_body,
                mesh=dmesh,
                in_specs=(P(ax), P(ax, None), P(ax)),
                out_specs=P(ax),
            )

            def minv(r):
                z = coarse_correct(r, ac_inv_p, mask)
                return z + apply_Dinv(r - apply_A(z))
        else:
            # Multilevel coarse (nc too big for a dense inverse): the coarse
            # system is small relative to the fine grid, so each device
            # solves it REPLICATED (one two-grid cycle on the all_gathered
            # restriction — dense level-2 correction + level-1 block-Jacobi
            # smooth) and keeps its own slice.  Communication stays one tiny
            # all_gather per apply.
            from navierstokes_tpu.ops.spmv import spmv_dia
            from navierstokes_tpu.solvers.coarse import prolong, restrict

            _, _, c_off, cs2 = c_static
            ac1, invd1_data, ac2_inv = c_arrays
            invd1_off = tuple(range(-3, 4))
            chunk = nc_pad // ndev
            n_smooth = self.cfg.krylov.coarse_ml_smooth
            n_cycles = self.cfg.krylov.coarse_ml_cycles
            damp = self.cfg.krylov.coarse_ml_damp

            from navierstokes_tpu.solvers.coarse import _mix_matrix

            def _coarse_body_ml(r_loc, ac1_r, invd1_r, ac2_r, mask_loc):
                hp = jax.lax.Precision.HIGHEST
                mix = _mix_matrix(agg, r_loc.dtype)
                rc_loc = jnp.matmul(r_loc.reshape(-1, 4 * agg), mix,
                                    precision=hp).reshape(-1)
                rc = jax.lax.all_gather(rc_loc, ax, tiled=True)[:nc]
                zc = jnp.zeros_like(rc)
                for _ in range(n_cycles):
                    r1 = rc - spmv_dia(c_off, ac1_r, zc)
                    zc = zc + prolong(cs2, jnp.matmul(
                        ac2_r, restrict(cs2, r1), precision=hp))
                    for _ in range(n_smooth):
                        # same damping requirement as the single-chip path
                        zc = zc + damp * spmv_dia(
                            invd1_off, invd1_r,
                            rc - spmv_dia(c_off, ac1_r, zc),
                        )
                zc = jnp.pad(zc, (0, nc_pad - nc))
                zc_loc = jax.lax.dynamic_slice(
                    zc, (jax.lax.axis_index(ax) * chunk,), (chunk,)
                )
                z_loc = jnp.matmul(zc_loc.reshape(-1, 4), mix.T,
                                   precision=hp).reshape(-1)
                return z_loc * mask_loc

            coarse_correct = jax.shard_map(
                _coarse_body_ml,
                mesh=dmesh,
                in_specs=(P(ax), P(), P(), P(), P(ax)),
                out_specs=P(ax),
            )

            def minv(r):
                z = coarse_correct(r, ac1, invd1_data, ac2_inv, mask)
                return z + apply_Dinv(r - apply_A(z))

        def matvec(x):
            return minv(apply_A(x))

        b_eff = minv(b)

        if solver_cfg.method == "ca_gmres":
            from navierstokes_tpu.solvers.sstep import ca_gmres

            res = ca_gmres(
                matvec, b_eff, basis=min(solver_cfg.restart, 16),
                rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter,
            )
        else:
            res = gmres(
                matvec, b_eff, restart=solver_cfg.restart,
                rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter,
            )
        return GMRESResult(
            x=res.x[:n], iters=res.iters, resnorm=res.resnorm,
            converged=res.converged,
        )

    def _solve_prepared_tlp(self, prep, rhs, solver_cfg):
        """Distributed two-level solve in the COMPONENT-PLANE layout.

        The flagship single-chip layout (`ops/plane_dia.py`) kept intact
        under distribution: nodes are row-partitioned with whole aggregates
        per device (`_plane_layout`), the whole Krylov space stays
        plane-major, each matvec is one (4, halo) ppermute exchange + the
        per-shard plane SpMV, D^{-1} is 16
        local elementwise plane multiplies, and the coarse correction is a
        local reshape-sum restriction + one tiny all_gather + a row-sharded
        dense solve (or a replicated multilevel cycle) + local broadcast
        prolongation — identical communication structure to the scalar
        `_solve_prepared_tl`, at 0.74x the operator bytes per shard.
        """
        from navierstokes_tpu.ops.plane_dia import from_planes, to_planes

        _, noffs, p4, d16, c_arrays, c_static, nb, nbp = prep
        if c_static[0] == "dense_lin":
            raise ValueError("coarse_basis='linear' is single-chip only")
        cs = c_static[1]
        agg = cs.agg_size
        dmesh, ax, ndev = self.device_mesh, self.axis, self.n_devices
        Lb = nbp // ndev
        assert Lb % agg == 0, (Lb, agg)
        nc_pad = 4 * (nbp // agg)
        hp = jax.lax.Precision.HIGHEST

        b = to_planes(rhs, nb, nbp)                        # (4*nbp,)
        # node mask: live nodes only (padding nodes stay identically zero)
        mask = (jnp.arange(nbp) < nb).astype(b.dtype)

        def apply_A(x):
            return partitioned_spmv_plane(dmesh, ax, noffs, p4, x, ndev)

        def _dinv_body(d16_loc, r_loc):
            # (16, Lb) x (4, Lb): block-diagonal D^{-1} as elementwise
            # plane multiplies — zero communication.
            return jnp.einsum(
                "abn,bn->an", d16_loc.reshape(4, 4, -1), r_loc, precision=hp
            )

        dinv_sharded = jax.shard_map(
            _dinv_body, mesh=dmesh,
            in_specs=(P(None, ax), P(None, ax)), out_specs=P(None, ax),
        )

        def apply_Dinv(r):
            return dinv_sharded(d16, r.reshape(4, nbp)).reshape(-1)

        if c_static[0] == "dense":
            nc = cs.nc
            ac_inv_p = jnp.pad(
                c_arrays[0], ((0, nc_pad - nc), (0, nc_pad - nc))
            )

            def _coarse_body(r_loc, acinv_loc, mask_loc):
                # local restriction: reshape-sum per plane over whole
                # aggregates, then interleave on the (tiny) coarse vector —
                # the plane trick of solvers.coarse.restrict_planes, per
                # shard.  Coarse dof 4g+c of aggregate g, component c.
                lb = r_loc.shape[1]
                rc_loc = r_loc.reshape(4, lb // agg, agg).sum(-1)
                rc_loc = rc_loc.T.reshape(-1)              # (4*lb/agg,)
                rc = jax.lax.all_gather(rc_loc, ax, tiled=True)  # (nc_pad,)
                zc_loc = jnp.matmul(acinv_loc, rc, precision=hp)
                z2 = zc_loc.reshape(-1, 4).T               # (4, lb/agg)
                z_loc = jnp.broadcast_to(
                    z2[:, :, None], (4, lb // agg, agg)
                ).reshape(4, lb)
                return z_loc * mask_loc[None, :]

            coarse_correct = jax.shard_map(
                _coarse_body, mesh=dmesh,
                in_specs=(P(None, ax), P(ax, None), P(ax)),
                out_specs=P(None, ax),
            )

            def coarse(r):
                return coarse_correct(
                    r.reshape(4, nbp), ac_inv_p, mask
                ).reshape(-1)
        else:
            # Multilevel coarse, replicated per device (same trade as the
            # scalar path: the coarse system is tiny relative to the fine
            # grid — one all_gather in, local slice out).
            from navierstokes_tpu.ops.spmv import spmv_dia
            from navierstokes_tpu.solvers.coarse import prolong, restrict

            _, _, c_off, cs2 = c_static
            ac1, invd1_data, ac2_inv = c_arrays
            invd1_off = tuple(range(-3, 4))
            nc = cs.nc
            chunk = nc_pad // ndev
            n_smooth = self.cfg.krylov.coarse_ml_smooth
            n_cycles = self.cfg.krylov.coarse_ml_cycles
            damp = self.cfg.krylov.coarse_ml_damp

            def _coarse_body_ml(r_loc, ac1_r, invd1_r, ac2_r, mask_loc):
                lb = r_loc.shape[1]
                rc_loc = r_loc.reshape(4, lb // agg, agg).sum(-1)
                rc_loc = rc_loc.T.reshape(-1)
                rc = jax.lax.all_gather(rc_loc, ax, tiled=True)[:nc]
                zc = jnp.zeros_like(rc)
                for _ in range(n_cycles):
                    r1 = rc - spmv_dia(c_off, ac1_r, zc)
                    zc = zc + prolong(cs2, jnp.matmul(
                        ac2_r, restrict(cs2, r1), precision=hp))
                    for _ in range(n_smooth):
                        zc = zc + damp * spmv_dia(
                            invd1_off, invd1_r,
                            rc - spmv_dia(c_off, ac1_r, zc),
                        )
                zc = jnp.pad(zc, (0, nc_pad - nc))
                zc_loc = jax.lax.dynamic_slice(
                    zc, (jax.lax.axis_index(ax) * chunk,), (chunk,)
                )
                z2 = zc_loc.reshape(-1, 4).T
                z_loc = jnp.broadcast_to(
                    z2[:, :, None], (4, lb // agg, agg)
                ).reshape(4, lb)
                return z_loc * mask_loc[None, :]

            coarse_correct = jax.shard_map(
                _coarse_body_ml, mesh=dmesh,
                in_specs=(P(None, ax), P(), P(), P(), P(ax)),
                out_specs=P(None, ax),
            )

            def coarse(r):
                return coarse_correct(
                    r.reshape(4, nbp), ac1, invd1_data, ac2_inv, mask
                ).reshape(-1)

        def minv(r):
            z = coarse(r)
            return z + apply_Dinv(r - apply_A(z))

        def matvec(x):
            return minv(apply_A(x))

        b_eff = minv(b)

        if solver_cfg.method == "ca_gmres":
            from navierstokes_tpu.solvers.sstep import ca_gmres

            res = ca_gmres(
                matvec, b_eff, basis=min(solver_cfg.restart, 16),
                rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter,
            )
        else:
            res = gmres(
                matvec, b_eff, restart=solver_cfg.restart,
                rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter,
            )
        return GMRESResult(
            x=from_planes(res.x, nb, nbp), iters=res.iters,
            resnorm=res.resnorm, converged=res.converged,
        )
