"""The transient Navier–Stokes engine — the reference's `solve_newton` stack
(`src/solve_newton.c:925-1323`) rebuilt for an accelerator.

Pipeline per run:
  1. Stokes initialization: assemble the steady Stokes operator (A0 | B^T /
     -B | D, no mass/convection — `assemble_stokes_matrix` `:617-662`) with
     the small Stokes Reynolds number, apply Dirichlet rows, GMRES-solve for
     the initial state (`:1037-1103`).
  2. Backward-Euler time loop with a Newton inner loop (`:1203-1297`):
     per iteration insert BC values, evaluate the residual, test convergence
     ((|F| < rtol*|F0| or |F| < atol) and |du| < atol, `:1231-1232`), then
     rebuild J = J_linear + nonlinear(u) (`:1245-1246`), zero BC rows with
     unit diagonal, and GMRES-solve J du = -F.

Design choices (not translations):
  - the whole Newton loop is ONE jitted `lax.while_loop` — zero host sync
    per iteration; per-iteration norms are recorded into fixed-size arrays,
  - the operator lives in the flat scalar-DIA layout, (re)built by one
    static 1-D scatter (pattern fixed); the two_level and schur
    preconditioners run on its component-plane form (ops/plane_dia.py),
  - preconditioning is batched-inverse block-Jacobi (+ optional Neumann
    boost or a two-level coarse correction) instead of sequential ILU
    triangular solves (SURVEY.md §7).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.config import NSConfig
from navierstokes_tpu.fem.assembly import (
    LINEAR_TERMS,
    NONLINEAR_TERMS,
    STOKES_TERMS,
    Discretization,
    assemble_dia_values,
    assemble_residual,
    build_discretization,
    local_fields,
)
from navierstokes_tpu.io.dat import write_petsc_vec
from navierstokes_tpu.io.vtu import write_pvd, write_vtu
from navierstokes_tpu.mesh.core import Mesh
from navierstokes_tpu.ops.block import block4_inverse
from navierstokes_tpu.ops.spmv import spmv_dia
from navierstokes_tpu.solvers.gmres import GMRESResult, gmres


class NewtonStats(NamedTuple):
    iters: jnp.ndarray          # Newton iterations performed
    converged: jnp.ndarray      # bool
    res_hist: jnp.ndarray       # (max_newton,) residual norms (nan-padded)
    du_hist: jnp.ndarray        # (max_newton,) update norms
    lin_iters: jnp.ndarray      # total GMRES iterations across the step


def _split_prep(prep):
    """Split a prepared-operator tuple into (static, arrays-pytree)."""
    if prep[0] == "defl":
        # defl: ("defl", inner_prep, U, Q) — GCRO recycled pair (k, n)
        # wrapped around any prepared operator (solvers/deflation.py).
        s, a = _split_prep(prep[1])
        return ("defl", s), (a, prep[2], prep[3])
    if prep[0] == "bj":
        return ("bj", prep[1], prep[3]), (prep[2], prep[4])
    if prep[0] == "sch":
        # sch: ("sch", node_offsets, p4, sch_arrays, sch_static, nb, nbp) —
        # the pressure-Schur block preconditioner (solvers/schur.py); p4 is
        # the full component-plane operator (index 2, like tlp, so the
        # residual-operator sharing in _ensure_prepared applies).
        return (("sch", prep[1], prep[4], prep[5], prep[6]),
                (prep[2], prep[3]))
    if prep[0] == "tlp":
        # tlp: ("tlp", node_offsets, plane_data, dinv_planes, c_arrays,
        #       c_static, nb, nbp[, cheby]) — the component-plane layout
        # (ops/plane_dia.py): two_level with 0.74x the operator bytes.
        # The optional trailing element is the static Chebyshev-smoother
        # interval (coarse_cheby > 0) — appended only when enabled so the
        # distributed unpack sites keep their exact arity.
        return (("tlp", prep[1], prep[5], prep[6], prep[7])
                + tuple(prep[8:]),
                (prep[2], prep[3], prep[4]))
    # tl: ("tl", offsets, dia_data, invd_offsets, invd_data, c_arrays,
    #      c_static[, cheby]) — c_arrays a tuple of device arrays, c_static
    # either ("dense", cs) or ("ml", cs, c_off, cs2)
    # (see _prepare_operator_dia).
    return (("tl", prep[1], prep[3], prep[6]) + tuple(prep[7:]),
            (prep[2], prep[4], prep[5]))


def _merge_prep(static, arrays):
    if static[0] == "defl":
        return ("defl", _merge_prep(static[1], arrays[0]),
                arrays[1], arrays[2])
    if static[0] == "bj":
        return ("bj", static[1], arrays[0], static[2], arrays[1])
    if static[0] == "sch":
        return ("sch", static[1], arrays[0], arrays[1],
                static[2], static[3], static[4])
    if static[0] == "tlp":
        return ("tlp", static[1], arrays[0], arrays[1], arrays[2],
                static[2], static[3], static[4]) + tuple(static[5:])
    return (
        "tl", static[1], arrays[0], static[2], arrays[1], arrays[2], static[3],
    ) + tuple(static[4:])


class NavierStokesSolver:
    """Flagship model: load mesh -> stokes init -> step -> dump, like the
    reference CLI, but as a library object with jitted compute."""

    # preconditioner="auto" resolves to the measured single-chip winners
    # (schur / coarse_cheby); the distributed subclass flips this so "auto"
    # degrades to the universally-supported two_level there.
    _auto_single_chip = True

    def __init__(self, mesh: Mesh, cfg: Optional[NSConfig] = None,
                 disc: Optional[Discretization] = None):
        from navierstokes_tpu.config import resolve_coarse_defaults

        # coarse_agg=None resolves to the measured per-size schedule here,
        # so everything downstream (aggregation build, distributed padding)
        # sees concrete numbers.  The UNRESOLVED config is kept separately:
        # checkpoints are fingerprinted against it so `run.py --resume`
        # (which holds the pre-resolution config) accepts checkpoints its
        # own run() wrote.
        self.user_cfg = cfg or NSConfig()
        self.cfg = resolve_coarse_defaults(
            self.user_cfg, mesh.nv, single_chip=self._auto_single_chip
        )
        if self.cfg.krylov.preconditioner == "schur":
            if self.cfg.krylov.spmv != "plane":
                raise ValueError(
                    "preconditioner='schur' requires spmv='plane' (the "
                    "sub-block applies run on the component-plane layout)"
                )
            if self.cfg.jacobian != "exact":
                raise ValueError(
                    "preconditioner='schur' requires jacobian='exact': the "
                    "Schur complement and coarse inverses are built on the "
                    "host at (eager) operator preparation"
                )
            if self.cfg.krylov.schur_shape not in ("lower", "full"):
                raise ValueError(
                    f"unknown schur_shape {self.cfg.krylov.schur_shape!r}; "
                    "expected 'lower' or 'full'"
                )
            if self.cfg.krylov.deflation_k:
                raise ValueError(
                    "deflation_k is not supported with preconditioner="
                    "'schur' (recycling is built on the tl/tlp preps)"
                )
        if self.cfg.krylov.ca_basis not in ("monomial", "newton"):
            raise ValueError(
                f"unknown ca_basis {self.cfg.krylov.ca_basis!r}; "
                "expected 'monomial' or 'newton'"
            )
        if (self.cfg.krylov.ca_basis == "newton"
                and self.cfg.krylov.method == "ca_gmres"
                and self.cfg.jacobian != "exact"):
            raise ValueError(
                "ca_basis='newton' requires jacobian='exact' (the shifts "
                "are Ritz values of the constant prepared operator)"
            )
        if self.cfg.krylov.coarse_cheby:
            if self.cfg.krylov.preconditioner != "two_level":
                raise ValueError(
                    "coarse_cheby is the two_level post-smoother; set "
                    "preconditioner='two_level' (or coarse_cheby=0)"
                )
            frac = self.cfg.krylov.coarse_cheby_fraction
            if not 0.0 < frac < 1.0:
                raise ValueError(
                    f"coarse_cheby_fraction must be in (0, 1), got {frac}"
                )
        dtype = self.cfg.jnp_dtype
        # `disc` lets config sweeps share one discretization (the host-side
        # pattern build dominates setup at 500k+ rows); it must have been
        # built with the same mesh/dtype.  NOTE: run() at large scale calls
        # release_assembly_buffers(), which mutates the shared disc.
        self.disc: Discretization = disc if disc is not None else \
            build_discretization(mesh, dtype=dtype, ell_slots=self.cfg.ell_slots)
        self.dtype = dtype

        # All large device arrays flow into the jitted step/stokes functions
        # as ARGUMENTS (this pytree), never as closure captures: closure
        # arrays are embedded as literal constants in the executable, which
        # bloats compile time, memory and the compile cache at multi-GB
        # operator sizes.
        d = self.disc
        self._consts = {
            "tets": d.tets, "vol": d.vol, "grad": d.grad, "h": d.h,
            "elem_map": d.dia_elem_map,
            "bc_is_bc": d.bc.is_bc, "bc_value": d.bc.value,
        }
        # Operator preparation (J_linear, exact prep, residual operators) is
        # LAZY — built on the first step()/prep access, not at construction.
        # Stokes init never reads them, and at 2.35M rows building them
        # first adds ~4 GB of prepared operators to the Stokes solve's peak
        # device memory (~3.7 GB of assembly arrays + the solve's own
        # temps).  Ordering stokes -> prepare -> (release) -> step keeps
        # every phase's peak bounded.
        self._prepared = False

        self._stokes_assemble_jit = jax.jit(self._stokes_dia)
        self._stokes_jit = jax.jit(self._stokes_solve)
        self._step_jit = jax.jit(self._newton_step)

    def _ensure_prepared(self):
        """Build J_linear / exact prep / residual operators once, on demand."""
        if self._prepared:
            return
        from navierstokes_tpu.sparse.dia import zero_rows_dia

        dtype = self.dtype
        # J_linear precomputed once (`preassemble_linear_jacobian`,
        # `src/solve_newton.c:1116-1146`), assembled DIRECTLY into the flat
        # scalar-DIA layout (the scalable path — see assemble_dia_values).
        dummy_UL = jnp.zeros((self.disc.ne, 3, 4), dtype=dtype)
        self._jlin_dia = self._assemble_dia(dummy_UL, LINEAR_TERMS)
        self._jlin_bc_dia = zero_rows_dia(
            self.disc.dia_pattern.offsets, self._jlin_dia, self.disc.bc.is_bc
        )
        if self.cfg.jacobian == "exact":
            # The residual's true Jacobian is constant: pre-scale it once.
            self._exact_prep_val = self._prepare_operator_dia(
                self._jlin_bc_dia
            )
            if self.cfg.krylov.deflation_k:
                # Recycle a harmonic-Ritz subspace of the (constant)
                # preconditioned operator once, project it out of every
                # subsequent solve (solvers/deflation.py).
                self._exact_prep_val = self._build_deflation(
                    self._exact_prep_val
                )
            if (self.cfg.krylov.method == "ca_gmres"
                    and self.cfg.krylov.ca_basis == "newton"):
                inner = self._exact_prep_val
                if inner[0] == "defl":
                    inner = inner[1]
                self._ca_shifts = self._build_ca_shifts(
                    inner, min(self.cfg.krylov.restart, 16)
                )
            static, arrays = _split_prep(self._exact_prep_val)
            self._prep_static = static
            self._consts["prep"] = arrays
        else:
            if self.cfg.krylov.deflation_k:
                raise ValueError(
                    "deflation_k requires jacobian='exact' (recycling "
                    "assumes a constant operator; the 'reference' mode "
                    "rebuilds it every Newton iteration)"
                )
            self._consts["jlin_dia"] = self._jlin_dia
        # Layout marker for the operator-form residual: True when res_A /
        # res_M are component-plane (4, NT, nbp) stacks, False for scalar
        # DIA (K, n).
        self._res_planes = False
        if self.cfg.residual == "operator":
            # Operator-form residual: F = A_lin u - (M/dt) u_old, both as
            # constant DIA operators (no per-iteration element scatter).
            offs = self.disc.dia_pattern.offsets
            if (
                self.cfg.jacobian == "exact"
                and self.cfg.krylov.preconditioner in ("two_level", "schur")
                and self.cfg.krylov.matvec_dtype is None
            ):
                # The residual operator differs from the prepared two_level
                # operator ONLY in BC rows (zero_rows_dia), which check()
                # masks out of F anyway — share the buffer instead of
                # holding a second full operator copy (761 MB at 2.35M
                # rows).  bj mode pre-scales by D^{-1}, so it cannot share.
                inner = self._exact_prep_val
                if inner[0] == "defl":
                    inner = inner[1]
                self._res_A = inner[2]
                self._res_planes = inner[0] in ("tlp", "sch")
            else:
                self._res_A = self._jlin_dia
            mass_dia = self._assemble_dia(
                dummy_UL, frozenset({"mass_dt_bare"})
            )
            if self._res_planes:
                # Plane-mode share: res_A is the component-plane prepared
                # operator; give the mass operator the same layout (same
                # padded node count, which the distributed layout sets) so
                # the residual runs plane-native.
                from navierstokes_tpu.ops.plane_dia import extract_planes

                self._res_M = extract_planes(
                    offs, mass_dia, self.disc.mesh.nv,
                    nbp=self._res_A.shape[2],
                )
            else:
                self._res_M = mass_dia
            self._consts["res_A"] = self._res_A
            self._consts["res_M"] = self._res_M
        self._prepared = True

    @property
    def _exact_prep(self):
        self._ensure_prepared()
        return self._exact_prep_val

    @property
    def _step_consts(self):
        """Consts subset the Newton step actually traces.

        In exact-Jacobian + operator-residual mode (the defaults) the step
        needs no assembly arrays at all — dropping them from the jit
        argument pytree keeps multi-GB scatter maps out of the step's
        executable signature at the 2.35M-row scale."""
        if self.cfg.jacobian == "exact" and self.cfg.residual == "operator":
            drop = {"tets", "vol", "grad", "h", "elem_map",
                    "ep_grad", "ep_vol", "ep_h", "ep_map", "ep_perm"}
            return {k: v for k, v in self._consts.items() if k not in drop}
        return self._consts

    def release_assembly_buffers(self):
        """Free assembly-time device arrays (geometry + element scatter map).

        At matrix-10 scale (2.35M rows) these hold ~3.7 GB of device memory
        the transient loop never reads: in exact-Jacobian + operator-residual
        mode every step works off the prepared operators alone.  Call AFTER
        `stokes_init` (the Stokes assembly needs them); `stokes_init`/
        reference-mode stepping afterwards would have to rebuild.
        """
        if not (self.cfg.jacobian == "exact"
                and self.cfg.residual == "operator"):
            raise RuntimeError(
                "release_assembly_buffers requires jacobian='exact' and "
                "residual='operator' (other modes assemble per step)"
            )
        self._ensure_prepared()      # prep needs the assembly arrays
        d = self.disc
        d.tets = d.vol = d.grad = d.h = d.dia_elem_map = None
        self._jlin_dia = None
        self._jlin_bc_dia = None
        for k in ("tets", "vol", "grad", "h", "elem_map"):
            self._consts.pop(k, None)
        if hasattr(self, "_ep_arrays"):
            for k in list(self._ep_arrays):
                self._consts.pop(k, None)
            self._ep_arrays = {}

    def _assemble_dia(self, UL, terms):
        d = self.disc
        return assemble_dia_values(
            d.tets, d.vol, d.grad, d.h, UL, self.cfg.dt, self.cfg.reynolds,
            self.cfg.delta, d.dia_elem_map, terms=terms,
            K=d.dia_pattern.K, ndof=d.ndof,
        )

    def _assemble_dia_c(self, consts, UL, terms, reynolds):
        """Jit-time DIA assembly from the consts pytree (overridable: the
        distributed solver reroutes this to per-shard element ranges)."""
        d = self.disc
        return assemble_dia_values(
            consts["tets"], consts["vol"], consts["grad"], consts["h"],
            UL, self.cfg.dt, reynolds, self.cfg.delta, consts["elem_map"],
            terms=terms, K=d.dia_pattern.K, ndof=d.ndof,
        )

    # -- operator plumbing --------------------------------------------------

    def _prepare_operator_dia(self, dia_data):
        """BC-applied DIA data -> prepared (operator, preconditioner).

        block_jacobi: S = D^{-1} A pre-scaled in DIA form (each GMRES
        iteration is exactly one SpMV); two_level: unscaled DIA operator +
        7-diagonal D^{-1} + dense coarse-grid inverse (see solvers/coarse).
        """
        from navierstokes_tpu.sparse.dia import (
            block_diag_to_dia,
            diag_blocks_from_dia,
            scale_rows_dia,
        )

        d = self.disc
        cfgk = self.cfg.krylov
        if cfgk.coarse_basis not in ("const", "linear"):
            # validate up front: an unknown value (e.g. a sweep typo) would
            # otherwise silently fall through to the const branch
            raise ValueError(
                f"unknown coarse_basis {cfgk.coarse_basis!r}; "
                "expected 'const' or 'linear'"
            )
        offsets = d.dia_pattern.offsets
        if cfgk.preconditioner == "schur":
            return self._prepare_operator_schur(offsets, dia_data)
        inv_diag = block4_inverse(
            diag_blocks_from_dia(offsets, dia_data, d.mesh.nv),
            pivot_eps=1e-300, shift=1e-8,
        )
        invd = block_diag_to_dia(inv_diag)
        mv_dtype = cfgk.matvec_dtype

        if cfgk.preconditioner == "two_level":
            from navierstokes_tpu.solvers.coarse import (
                build_aggregates,
                coarse_dia_offsets,
                coarse_operator_dia,
                coarse_operator_inverse_dia,
            )

            if not hasattr(self, "_coarse_space"):
                self._coarse_space = build_aggregates(d.mesh.nv, cfgk.coarse_agg)
            cs = self._coarse_space
            if cfgk.coarse_basis == "linear":
                # Per-aggregate {1, x, y, z} basis (16 dofs/aggregate):
                # richer coarse space at the same dense nc via 4x-larger
                # aggregates — see solvers.coarse.build_linear_weights.
                if not self._plane_mode():
                    raise ValueError(
                        "coarse_basis='linear' requires spmv='plane' (the "
                        "single-chip component-plane path)"
                    )
                if cfgk.coarse_smooth_omega:
                    raise ValueError(
                        "coarse_basis='linear' and coarse_smooth_omega are "
                        "mutually exclusive"
                    )
                if 16 * cs.n_agg > cfgk.coarse_dense_max:
                    raise ValueError(
                        "coarse_basis='linear' is supported on the dense "
                        f"coarse path only (nc={16 * cs.n_agg} > "
                        f"coarse_dense_max={cfgk.coarse_dense_max}); raise "
                        "coarse_agg or coarse_dense_max"
                    )
                from navierstokes_tpu.solvers.coarse import (
                    build_linear_weights,
                    linear_coarse_inverse_dia,
                )

                w_host = build_linear_weights(
                    cs, np.asarray(d.mesh.coords))
                ac_inv = linear_coarse_inverse_dia(
                    cs, offsets, dia_data, w_host,
                    shift=cfgk.coarse_shift,
                )
                c_arrays = (ac_inv, jnp.asarray(w_host, dtype=self.dtype))
                c_static = ("dense_lin", cs)
            elif cs.nc <= cfgk.coarse_dense_max:
                if cfgk.coarse_smooth_omega:
                    # Smoothed-aggregation basis: host Petrov-Galerkin
                    # product (see solvers.coarse); the matching smoothed
                    # prolongation happens on the fly in _prep_operators.
                    from navierstokes_tpu.solvers.coarse import (
                        smoothed_coarse_inverse_dia,
                    )

                    ac_inv = smoothed_coarse_inverse_dia(
                        cs, offsets, dia_data, inv_diag,
                        omega=cfgk.coarse_smooth_omega,
                        shift=cfgk.coarse_shift,
                    )
                else:
                    ac_inv = coarse_operator_inverse_dia(
                        cs, offsets, dia_data, shift=cfgk.coarse_shift
                    )
                c_arrays = (ac_inv,)
                c_static = ("dense", cs)
            elif cfgk.coarse_smooth_omega:
                raise ValueError(
                    "coarse_smooth_omega is supported on the dense coarse "
                    f"path only (nc={cs.nc} > coarse_dense_max="
                    f"{cfgk.coarse_dense_max}); raise coarse_dense_max or "
                    "coarse_agg"
                )
            else:
                # Scalable multilevel path: the coarse operator stays sparse
                # (DIA) with block-Jacobi smoothing, and only a SECOND,
                # smaller aggregation level is inverted densely — replaces
                # the O(nc^2)-memory dense inverse that cannot run at 511k+
                # rows (the scale role ILU(k) plays in the reference,
                # `src/solve_newton.c:1159-1162`).
                if not hasattr(self, "_coarse_l2"):
                    c_off = coarse_dia_offsets(offsets, cs.agg_size)
                    agg2 = max(-(-cs.nc // cfgk.coarse_dense_max), 2)
                    cs2 = build_aggregates(cs.n_agg, agg2)
                    if cs2.nc > cfgk.coarse_dense_max:
                        raise ValueError(
                            f"second coarse level still too large "
                            f"(nc2={cs2.nc} > {cfgk.coarse_dense_max}); "
                            "raise coarse_agg or coarse_dense_max"
                        )
                    self._coarse_l2 = (c_off, cs2)
                c_off, cs2 = self._coarse_l2
                ac1 = coarse_operator_dia(
                    cs, offsets, dia_data, c_off, shift=cfgk.coarse_shift
                )
                from navierstokes_tpu.sparse.dia import (
                    block_diag_to_dia as _bd2d,
                    diag_blocks_from_dia as _dbfd,
                )

                invd1 = _bd2d(block4_inverse(
                    _dbfd(c_off, ac1, cs.n_agg), pivot_eps=1e-300, shift=1e-8
                ))
                ac2_inv = coarse_operator_inverse_dia(
                    cs2, c_off, ac1, shift=cfgk.coarse_shift
                )
                c_arrays = (ac1, invd1.data, ac2_inv)
                c_static = ("ml", cs, c_off, cs2)
            if self._plane_mode():
                # Component-plane layout (the reference's by-component DoF
                # ordering, `src/create_mat.c:55-61`, as the performance
                # layout): operator stored as 16 plane couplings over the
                # N_D node diagonals — 0.74x the scalar-DIA bytes on the
                # channel family (bench/layout_census.py), applied by
                # ops/plane_dia.spmv_planes.  D^{-1} becomes 16
                # elementwise plane multiplies (vs a 7-diagonal SpMV).
                from navierstokes_tpu.ops.plane_dia import (
                    extract_planes,
                    node_offsets_from_scalar,
                )

                nb = d.mesh.nv
                noffs = node_offsets_from_scalar(offsets)
                nbp = self._plane_layout(nb, noffs)
                p4 = extract_planes(offsets, dia_data, nb,
                                    node_offsets=noffs, nbp=nbp)
                # (nb, 4, 4) inverted diagonal blocks -> (16, nbp) planes:
                # row 4a+b holds D^{-1}[:, a, b].
                d16 = jnp.pad(
                    inv_diag, ((0, nbp - nb), (0, 0), (0, 0))
                ).transpose(1, 2, 0).reshape(16, nbp)
                return self._maybe_append_cheby(
                    ("tlp", noffs, p4, d16, c_arrays, c_static, nb, nbp)
                )
            if mv_dtype is not None:
                dia_data = dia_data.astype(jnp.dtype(mv_dtype))
            return self._maybe_append_cheby((
                "tl", offsets, dia_data, invd.offsets, invd.data,
                c_arrays, c_static,
            ))

        s_offsets, s_data = scale_rows_dia(d.dia_pattern, dia_data, inv_diag)
        if mv_dtype is not None:
            s_data = s_data.astype(jnp.dtype(mv_dtype))
        return ("bj", s_offsets, s_data, invd.offsets, invd.data)

    def _prepare_operator_schur(self, offsets, dia_data):
        """BC-applied DIA data -> ("sch", ...) pressure-Schur prep.

        Everything Schur-specific is built on the HOST in f64 once per
        operator preparation (solvers/schur.py): the 3x3 velocity diagonal
        inverse, the SIMPLE Schur complement S_hat = D + B diag(F)^{-1} B^T
        in scalar node-DIA form, the dense velocity/pressure coarse
        inverses, and the Chebyshev smoothing intervals (power iteration).
        The device half is plane stacks for the generic plane SpMV
        (`ops.plane_dia.spmv_planes`): the full 4x4 operator p4
        (GMRES matvec), F (3x3), A_pu = -B (1x3), optionally A_up = B^T
        (3x1, schur_shape='full'), and S_hat (1x1, doubled offsets)."""
        from navierstokes_tpu.ops.plane_dia import (
            extract_planes,
            node_offsets_from_scalar,
            plane_terms,
        )
        from navierstokes_tpu.solvers import schur as sch
        from navierstokes_tpu.solvers.coarse import build_aggregates

        d = self.disc
        cfgk = self.cfg.krylov
        nb = d.mesh.nv
        try:
            dd = np.asarray(dia_data)
        except (jax.errors.ConcretizationTypeError,
                jax.errors.TracerArrayConversionError) as e:
            raise ValueError(
                "preconditioner='schur' requires eager operator "
                "preparation (jacobian='exact'): the Schur complement and "
                "coarse inverses are host-side computations"
            ) from e
        noffs = node_offsets_from_scalar(offsets)
        nbp = self._plane_layout(nb, noffs)
        if not hasattr(self, "_coarse_space"):
            self._coarse_space = build_aggregates(nb, cfgk.coarse_agg)
        cs = self._coarse_space
        if 3 * cs.n_agg > cfgk.coarse_dense_max:
            raise ValueError(
                "preconditioner='schur' uses dense coarse inverses "
                f"(velocity nc={3 * cs.n_agg} > coarse_dense_max="
                f"{cfgk.coarse_dense_max}); raise coarse_agg or "
                "coarse_dense_max"
            )
        dt = self.dtype

        p4 = extract_planes(offsets, dia_data, nb, node_offsets=noffs,
                            nbp=nbp)

        a_blk = sch.split_blocks(offsets, dd, nb, noffs)
        fd_inv = sch.diag_f_inverse(a_blk, noffs)

        def planes_dev(planes_np):
            return jnp.asarray(
                np.pad(planes_np, ((0, 0), (0, 0), (0, nbp - nb))), dtype=dt)

        terms3 = plane_terms(noffs, 3)
        pf_np = np.empty((3, len(terms3), nb), dtype=np.float64)
        pb_np = np.empty((1, len(terms3), nb), dtype=np.float64)
        for j, (b, dn) in enumerate(terms3):
            i_d = noffs.index(dn)
            for a in range(3):
                pf_np[a, j] = a_blk[i_d, :, a, b]
            pb_np[0, j] = a_blk[i_d, :, 3, b]
        p_f, p_b = planes_dev(pf_np), planes_dev(pb_np)
        p_g = None
        if cfgk.schur_shape == "full":
            terms1 = plane_terms(noffs, 1)
            pg_np = np.empty((3, len(terms1), nb), dtype=np.float64)
            for j, (_, dn) in enumerate(terms1):
                i_d = noffs.index(dn)
                for a in range(3):
                    pg_np[a, j] = a_blk[i_d, :, a, 3]
            p_g = planes_dev(pg_np)

        # (nb, 3, 3) -> (9, nbp) planes: row 3a+b holds diag(F)^{-1}[:, a, b]
        d9 = jnp.asarray(
            np.pad(fd_inv, ((0, nbp - nb), (0, 0), (0, 0)))
            .transpose(1, 2, 0).reshape(9, nbp), dtype=dt,
        )

        s_offs, s_np = sch.build_schur_dia(a_blk, noffs, nb, fd_inv)
        sd = s_np[s_offs.index(0)].copy()
        sd[sd == 0.0] = 1.0
        sdinv_np = 1.0 / sd
        s_dinv = jnp.asarray(np.pad(sdinv_np, (0, nbp - nb)), dtype=dt)
        s_planes = planes_dev(s_np[None, :, :])

        vc_inv = jnp.asarray(
            sch.velocity_coarse_inverse(cs, a_blk, noffs,
                                        shift=cfgk.coarse_shift), dtype=dt)
        sc_inv = jnp.asarray(
            sch.scalar_coarse_inverse(cs, s_offs, s_np,
                                      shift=cfgk.coarse_shift), dtype=dt)

        frac = cfgk.coarse_cheby_fraction
        cheby_s = cheby_v = None
        if cfgk.schur_cheby:
            lmax = sch.power_lmax_schur(s_offs, s_np, sdinv_np)
            a_, b_ = frac * lmax, 1.05 * lmax
            cheby_s = (float((a_ + b_) / 2), float((b_ - a_) / 2),
                       int(cfgk.schur_cheby))
        if cfgk.schur_v_cheby:
            lmax = sch.power_lmax_velocity(a_blk, noffs, fd_inv)
            a_, b_ = frac * lmax, 1.05 * lmax
            cheby_v = (float((a_ + b_) / 2), float((b_ - a_) / 2),
                       int(cfgk.schur_v_cheby))

        static = (cs, sch.SchurStatic(
            s_offsets=s_offs, cheby_s=cheby_s, cheby_v=cheby_v,
            shape=cfgk.schur_shape,
        ))
        arrays = (p_f, p_b, p_g, d9, s_planes, s_dinv, vc_inv, sc_inv)
        return ("sch", noffs, p4, arrays, static, nb, nbp)

    def _prepare_operator(self, bcsr_values):
        """Compatibility wrapper: BC-applied BCSR block values -> prepared
        operator via the DIA path."""
        from navierstokes_tpu.sparse.dia import dia_values_from_bcsr_values

        d = self.disc
        dia_data = dia_values_from_bcsr_values(
            d.dia_pattern, bcsr_values, flat_map_dev=d.dia_flat_map
        )
        return self._prepare_operator_dia(dia_data)

    def _plane_mode(self) -> bool:
        """Component-plane operator layout (SolverConfig.spmv='plane').

        Explicit opt-in; requires the two_level preconditioner (the bj path
        pre-scales by D^{-1}, which fills the block band — stays scalar).
        Works single-chip AND distributed (round 4): the distributed solver
        node-partitions the planes and runs the same plane kernel per shard
        (`parallel.partitioned_spmv_plane`)."""
        return self.cfg.krylov.spmv == "plane"

    def _plane_layout(self, nb: int, node_offsets: tuple) -> int:
        """Padded node count nbp of the component-plane operator layout:
        whole coarse aggregates (the plane restriction reshape-sums over
        them).  The distributed subclass overrides this so every device
        also gets whole aggregates and a node halo that fits its slice."""
        agg = self.cfg.krylov.coarse_agg
        return -(-nb // agg) * agg

    def _make_coarse_solve(self, c_arrays, c_static):
        """Coarse-level solve closure shared by the scalar ('tl') and
        component-plane ('tlp') two-level paths.  Dense: one (nc, nc) GEMV.
        Multilevel: the sparse level-1 coarse system is itself solved by one
        two-grid cycle (dense level-2 correction + damped level-1
        block-Jacobi smoothing) — same structure, one level down."""
        if c_static[0] in ("dense", "dense_lin"):
            def coarse_solve(rc):
                # HIGHEST: a reduced default matmul precision (TF32 on the
                # GPU) would round A_c^{-1} AND rc (see solvers.coarse.
                # restrict).
                return jnp.matmul(c_arrays[0], rc,
                                  precision=jax.lax.Precision.HIGHEST)
            return coarse_solve

        from navierstokes_tpu.solvers.coarse import prolong, restrict

        _, _, c_off, cs2 = c_static
        ac1, invd1_data, ac2_inv = c_arrays
        invd1_off = tuple(range(-3, 4))
        n_smooth = self.cfg.krylov.coarse_ml_smooth
        n_cycles = self.cfg.krylov.coarse_ml_cycles
        damp = self.cfg.krylov.coarse_ml_damp

        def coarse_solve(rc):
            zc = jnp.zeros_like(rc)
            for _ in range(n_cycles):
                r1 = rc - spmv_dia(c_off, ac1, zc)
                zc = zc + prolong(cs2, jnp.matmul(
                    ac2_inv, restrict(cs2, r1),
                    precision=jax.lax.Precision.HIGHEST))
                for _ in range(n_smooth):
                    # damp < 1 required for stability when smoothing:
                    # undamped Jacobi diverges on the saddle-point
                    # coarse operator (see SolverConfig.coarse_ml_damp)
                    zc = zc + damp * spmv_dia(
                        invd1_off, invd1_data,
                        rc - spmv_dia(c_off, ac1, zc),
                    )
            return zc

        return coarse_solve

    # -- Chebyshev polynomial smoothing (SolverConfig.coarse_cheby) ----------

    _supports_cheby = True   # the distributed subclass opts out (the tlp/tl
                             # unpack sites there are exact-arity by design)

    def _maybe_append_cheby(self, prep):
        """Append the static Chebyshev interval to a two_level prep tuple.

        coarse_cheby=0 (default): no-op, tuple arity unchanged.  Otherwise
        estimates lmax of the Jacobi-preconditioned operator G = D^{-1}A by
        a short Arnoldi sweep (once, eagerly, at operator preparation) and
        appends (theta, delta, degree) for the smoothing interval
        [f*lmax, 1.05*lmax], f = coarse_cheby_fraction."""
        deg = self.cfg.krylov.coarse_cheby
        if not deg:
            return prep
        if not self._supports_cheby:
            raise ValueError(
                "coarse_cheby is single-chip only (the distributed solve "
                "paths smooth with one Jacobi application)"
            )
        if isinstance(prep[2], jax.core.Tracer):
            raise ValueError(
                "coarse_cheby requires eager operator preparation "
                "(jacobian='exact'): the interval estimate is a host-side "
                "eigenvalue computation"
            )
        lmax = self._estimate_smoother_lmax(prep)
        frac = self.cfg.krylov.coarse_cheby_fraction  # validated in __init__
        a, b = frac * lmax, 1.05 * lmax
        return prep + ((float((a + b) / 2), float((b - a) / 2), int(deg)),)

    def _build_ca_shifts(self, prep, s: int) -> tuple:
        """Leja-ordered Newton-basis shifts for ca_gmres (ca_basis='newton').

        One m-step Arnoldi sweep on the PRECONDITIONED constant operator
        (same closure discipline as `_build_deflation`: operator arrays as
        jit arguments), host-side Ritz eig + Leja ordering
        (solvers.sstep.newton_shifts).  Eager, once per preparation."""
        from navierstokes_tpu.solvers.deflation import arnoldi
        from navierstokes_tpu.solvers.sstep import newton_shifts

        rhs = self.disc.bc.value.astype(self.dtype)
        if not float(jnp.linalg.norm(rhs)):
            rhs = jnp.ones_like(rhs)
        if prep[0] in ("tlp", "sch"):
            from navierstokes_tpu.ops.plane_dia import to_planes

            nb, nbp = (prep[6], prep[7]) if prep[0] == "tlp" \
                else (prep[5], prep[6])
            rhs = to_planes(rhs, nb, nbp)
        m = min(max(2 * s, 32), rhs.shape[0] - 2)
        static, arrays = _split_prep(prep)

        def _arn(arrs, r):
            p = _merge_prep(static, arrs)
            matvec, b_prep, _ = self._prep_operators(p)
            return arnoldi(matvec, b_prep(r), m)

        _, H = jax.jit(_arn)(arrays, rhs)
        return newton_shifts(np.asarray(H), s)

    def _estimate_smoother_lmax(self, prep, m: int = 20) -> float:
        """max |Ritz value| of G = D^{-1}A from an m-step Arnoldi sweep.

        Same closure discipline as `_build_deflation`: operator arrays flow
        in as jit arguments, never as embedded constants.  The start vector
        is the (deterministic) BC value vector, falling back to ones when
        it is identically zero."""
        from navierstokes_tpu.solvers.deflation import arnoldi

        rhs = self.disc.bc.value.astype(self.dtype)
        if not float(jnp.linalg.norm(rhs)):
            rhs = jnp.ones_like(rhs)
        if prep[0] == "tlp":
            from navierstokes_tpu.ops.plane_dia import to_planes

            rhs = to_planes(rhs, prep[6], prep[7])
        m = min(m, rhs.shape[0] - 2)
        static, arrays = _split_prep(prep)

        def _arn(arrs, r):
            p = _merge_prep(static, arrs)
            _, _, parts = self._prep_operators(p)

            def g(x):
                return parts["apply_Dinv"](parts["apply_A"](x))

            return arnoldi(g, r, m)

        _, H = jax.jit(_arn)(arrays, rhs)
        theta = np.linalg.eigvals(np.asarray(H, dtype=np.float64)[:m])
        return float(np.max(np.abs(theta)))

    @staticmethod
    def _make_smoother(apply_A, apply_Dinv, cheby):
        """Post-smoother for the two-grid cycle.

        cheby=None (default): one damped-Jacobi application (z += D^{-1} s).
        cheby=(theta, delta, deg): the degree-`deg` Chebyshev polynomial in
        G = D^{-1}A over the interval [theta - delta, theta + delta] (the
        classic AMG polynomial smoother — Adams/Brezina/Hu/Tuminaro 2003
        recurrence, as in hypre/ML).  Each extra degree = one apply_A + one
        apply_Dinv; all coefficients are static compile-time floats."""
        if not cheby:
            return apply_Dinv
        theta, delta, deg = cheby
        sigma1 = theta / delta

        def smooth(s):
            dk = apply_Dinv(s) * (1.0 / theta)
            x = dk
            rho_prev = 1.0 / sigma1
            for _ in range(deg - 1):
                rk = s - apply_A(x)
                rho = 1.0 / (2.0 * sigma1 - rho_prev)
                dk = (rho * rho_prev) * dk + (2.0 * rho / delta) * \
                    apply_Dinv(rk)
                x = x + dk
                rho_prev = rho
            return x

        return smooth

    def _prep_operators(self, prep):
        """Prepared tuple -> (matvec, b_prep, parts).

        `matvec` is the preconditioned operator GMRES iterates, `b_prep`
        maps the raw RHS to the left-preconditioned one, and `parts` holds
        the component applies (apply_A, apply_Dinv, coarse / apply_S) so
        `bench/gmres_decomp` can time the REAL solver components
        individually rather than re-implementations of them."""
        if prep[0] == "sch":
            from navierstokes_tpu.ops.plane_dia import spmv_planes
            from navierstokes_tpu.solvers.schur import (
                prolong_planes_n,
                restrict_planes_n,
            )

            _, noffs, p4, arrs, stat, nb, nbp = prep
            p_f, p_b, p_g, d9, s_planes, s_dinv, vc_inv, sc_inv = arrs
            cs, ss = stat
            hp = jax.lax.Precision.HIGHEST

            def apply_A(x):
                return spmv_planes(noffs, p4, x)

            def apply_F(xu):
                return spmv_planes(noffs, p_f, xu)

            def apply_pu(xu):          # the pressure row: A_pu = -B
                return spmv_planes(noffs, p_b, xu)

            def apply_S(xp):
                return spmv_planes(ss.s_offsets, s_planes, xp)

            def dinv_f(ru):
                # 3x3 block-diagonal inverse as 9 elementwise plane
                # multiplies (the velocity analog of the tlp d16 apply)
                r3 = ru.reshape(3, nbp)
                return jnp.einsum("abn,bn->an", d9.reshape(3, 3, nbp), r3,
                                  precision=hp).reshape(-1)

            def dinv_s(rp):
                return s_dinv * rp

            smooth_v = self._make_smoother(apply_F, dinv_f, ss.cheby_v)
            smooth_s = self._make_smoother(apply_S, dinv_s, ss.cheby_s)

            def fhat(ru):
                # velocity two-grid: dense aggregation coarse + smoother
                zc = jnp.matmul(vc_inv, restrict_planes_n(cs, ru, nbp, 3),
                                precision=hp)
                z = prolong_planes_n(cs, zc, nbp, nb, 3)
                return z + smooth_v(ru - apply_F(z))

            def shat(rp):
                # pressure-Schur two-grid (S_hat ~SPD: Chebyshev is sound)
                zc = jnp.matmul(sc_inv, restrict_planes_n(cs, rp, nbp, 1),
                                precision=hp)
                z = prolong_planes_n(cs, zc, nbp, nb, 1)
                return z + smooth_s(rp - apply_S(z))

            def minv(r):
                # block lower-triangular solve M z = r:
                #   [ F_hat   0     ] [z_u]   [r_u]
                #   [ A_pu    S_hat ] [z_p] = [r_p]
                # (signs verbatim from the operator blocks: A_pu = -B);
                # schur_shape='full' adds the A_up = B^T back-substitution.
                r2 = r.reshape(4, nbp)
                zu = fhat(r2[:3].reshape(-1))
                zp = shat(r2[3] - apply_pu(zu))
                if ss.shape == "full":
                    zu = zu - fhat(spmv_planes(noffs, p_g, zp))
                return jnp.concatenate(
                    [zu.reshape(3, nbp), zp[None]], 0
                ).reshape(-1)

            def matvec(x):
                return minv(apply_A(x))

            parts = {
                "apply_A": apply_A,
                "apply_F": apply_F,
                "apply_S": apply_S,
                "fhat": fhat,
                "shat": shat,
                "minv": minv,
            }
            return matvec, minv, parts

        if prep[0] == "tlp":
            from navierstokes_tpu.ops.plane_dia import spmv_planes
            from navierstokes_tpu.solvers.coarse import (
                prolong_planes,
                prolong_planes_linear,
                restrict_planes,
                restrict_planes_linear,
            )

            _, noffs, p4, d16, c_arrays, c_static, nb, nbp = prep[:8]
            cs = c_static[1]
            coarse_solve = self._make_coarse_solve(c_arrays, c_static)

            def apply_A(x):
                return spmv_planes(noffs, p4, x)

            def apply_Dinv(r):
                # Block-diagonal D^{-1} in plane layout: 16 elementwise
                # multiplies over (nbp,) planes — no shifted slices at all.
                r2 = r.reshape(4, nbp)
                return jnp.einsum("abn,bn->an",
                                  d16.reshape(4, 4, nbp), r2,
                                  precision=jax.lax.Precision.HIGHEST,
                                  ).reshape(-1)

            om = self.cfg.krylov.coarse_smooth_omega
            lin_w = c_arrays[1] if c_static[0] == "dense_lin" else None

            def coarse(r):
                # Restriction/prolongation natively on planes (reshape-sum /
                # broadcast); the plane<->interleaved conversion happens on
                # the COARSE vector only (nc <= ~16k: free), so the existing
                # dense/multilevel coarse_solve is reused unchanged.
                if lin_w is not None:
                    # per-aggregate linear basis: weighted batched
                    # reshape-sums (solvers.coarse.restrict_planes_linear)
                    zc = coarse_solve(
                        restrict_planes_linear(cs, r, nbp, lin_w))
                    return prolong_planes_linear(cs, zc, nbp, nb, lin_w)
                zc = coarse_solve(restrict_planes(cs, r, nbp))
                z = prolong_planes(cs, zc, nbp, nb)
                if om:
                    # smoothed-aggregation prolongator, applied on the fly:
                    # P zc = (I - om D^{-1} A) P0 zc (matches the Galerkin
                    # matrix built by smoothed_coarse_dense_matrix)
                    z = z - om * apply_Dinv(apply_A(z))
                return z

            smooth = self._make_smoother(
                apply_A, apply_Dinv, prep[8] if len(prep) > 8 else None
            )

            def minv(r):
                z = coarse(r)
                return z + smooth(r - apply_A(z))

            def matvec(x):
                return minv(apply_A(x))

            parts = {
                "apply_A": apply_A,
                "apply_Dinv": apply_Dinv,
                "coarse": coarse,
                "minv": minv,
            }
            return matvec, minv, parts

        if prep[0] == "tl":
            from navierstokes_tpu.solvers.coarse import prolong, restrict

            _, a_offsets, a_data, invd_offsets, invd_data, c_arrays, c_static \
                = prep[:7]
            cs = c_static[1]

            def apply_A(x):
                return spmv_dia(a_offsets, a_data, x)

            def apply_Dinv(r):
                return spmv_dia(invd_offsets, invd_data, r)

            coarse_solve = self._make_coarse_solve(c_arrays, c_static)
            om = self.cfg.krylov.coarse_smooth_omega

            def coarse(r):
                z = prolong(cs, coarse_solve(restrict(cs, r)))
                if om:
                    # smoothed-aggregation prolongator (see the tlp path)
                    z = z - om * apply_Dinv(apply_A(z))
                return z

            smooth = self._make_smoother(
                apply_A, apply_Dinv, prep[7] if len(prep) > 7 else None
            )

            def minv(r):
                # multiplicative two-grid: coarse correction + smooth
                # (one Jacobi application, or a Chebyshev sweep —
                # see _make_smoother)
                z = coarse(r)
                return z + smooth(r - apply_A(z))

            def matvec(x):
                return minv(apply_A(x))

            parts = {
                "apply_A": apply_A,
                "apply_Dinv": apply_Dinv,
                "coarse": coarse,
                "minv": minv,
            }
            return matvec, minv, parts

        _, s_offsets, s_data, invd_offsets, invd_data = prep
        order = self.cfg.krylov.neumann_order

        def apply_S(x):
            return spmv_dia(s_offsets, s_data, x)

        def neumann(r):
            acc = r
            cur = r
            for _ in range(order):
                cur = cur - apply_S(cur)
                acc = acc + cur
            return acc

        def matvec(x):
            return neumann(apply_S(x))

        def b_prep(rhs):
            return neumann(spmv_dia(invd_offsets, invd_data, rhs))

        return matvec, b_prep, {"apply_S": apply_S, "neumann": neumann}

    # -- Krylov subspace recycling (solvers/deflation.py) --------------------

    _supports_deflation = True   # the distributed subclass opts out

    def _build_deflation(self, prep):
        """Wrap a prepared operator with a GCRO recycled pair ("defl",
        prep, U, Q) — see solvers.deflation for the algebra.  Eager, once:
        one m-step Arnoldi on-device (operator arrays as jit ARGUMENTS, the
        closure discipline of this file) + one tiny host eig."""
        from navierstokes_tpu.solvers.deflation import (
            arnoldi,
            harmonic_ritz_basis,
            recycle_space,
        )

        if not self._supports_deflation:
            raise ValueError(
                "deflation_k is single-chip only (the recycled GEMVs are "
                "not sharded); drop it or run single-device"
            )
        cfgk = self.cfg.krylov
        if cfgk.method != "gmres":
            raise ValueError(
                "deflation_k requires method='gmres' (the projected solve "
                "wraps the standard restarted GMRES)"
            )
        k = cfgk.deflation_k
        m = cfgk.deflation_arnoldi or max(3 * k, 48)

        # Raw-layout start vector: the preconditioned BC rhs (physically
        # representative and deterministic).
        rhs = self.disc.bc.value.astype(self.dtype)
        if prep[0] == "tlp":
            from navierstokes_tpu.ops.plane_dia import to_planes

            rhs = to_planes(rhs, prep[6], prep[7])
        n_raw = rhs.shape[0]
        m = min(m, n_raw - 2)
        k = min(k, max(m - 2, 1))
        static, arrays = _split_prep(prep)

        def _arn(arrs, r):
            p = _merge_prep(static, arrs)
            matvec, b_prep, _ = self._prep_operators(p)
            return arnoldi(matvec, b_prep(r), m)

        V, H = jax.jit(_arn)(arrays, rhs)
        Y = jnp.asarray(
            harmonic_ritz_basis(np.asarray(H), k), dtype=self.dtype
        )
        U, Q = jax.jit(recycle_space)(V, H, Y)
        del V
        return ("defl", prep, U, Q)

    def _solve_deflated(self, prep, U, Q, rhs, solver_cfg):
        """Deflated GMRES: solve in the orthogonal complement of the
        recycled space, then correct the recycled directions exactly.
        The inner residual IS the true preconditioned residual (see
        solvers/deflation.py), so tolerances keep their meaning."""
        matvec, b_prep, _ = self._prep_operators(prep)
        b_eff = b_prep(rhs)
        hp = jax.lax.Precision.HIGHEST
        c0 = jnp.matmul(Q, b_eff, precision=hp)
        r0 = b_eff - jnp.matmul(Q.T, c0, precision=hp)

        def matvec_defl(x):
            w = matvec(x)
            return w - jnp.matmul(
                Q.T, jnp.matmul(Q, w, precision=hp), precision=hp
            )

        # Tolerance semantics: the inner residual IS the true preconditioned
        # residual (see module docstring), so the convergence target must be
        # rtol * ||b_eff|| — the UNdeflated norm, exactly what the plain solve
        # uses.  Normalizing against ||r0|| = ||(I-QQ^T) b_eff|| instead is a
        # trap: Q is built to capture precisely the dominant smooth content
        # of b, so ||r0|| can be orders of magnitude below ||b_eff|| and the
        # effective tolerance becomes brutally strict (measured: early m8
        # transient steps ran to maxiter, mean lin 515 vs 113 baseline).
        res = gmres(
            matvec_defl, r0, restart=solver_cfg.restart,
            rtol=0.0,
            atol=jnp.maximum(
                solver_cfg.rtol * jnp.linalg.norm(b_eff), solver_cfg.atol
            ),
            maxiter=solver_cfg.maxiter,
        )
        # x = y + U (Q^T (b - T y)): one extra T apply per SOLVE (not per
        # iteration) buys the exact recycled-direction correction.
        a = c0 - jnp.matmul(Q, matvec(res.x), precision=hp)
        x = res.x + jnp.matmul(U.T, a, precision=hp)
        return GMRESResult(x=x, iters=res.iters, resnorm=res.resnorm,
                           converged=res.converged)

    def _solve_prepared(self, prep, rhs, solver_cfg):
        """Left-preconditioned GMRES on the prepared operator."""
        if prep[0] == "defl":
            _, inner, U, Q = prep
            if inner[0] == "tlp":
                from navierstokes_tpu.ops.plane_dia import (
                    from_planes,
                    to_planes,
                )

                nb, nbp = inner[6], inner[7]
                res = self._solve_deflated(
                    inner, U, Q, to_planes(rhs, nb, nbp), solver_cfg
                )
                return res._replace(x=from_planes(res.x, nb, nbp))
            return self._solve_deflated(inner, U, Q, rhs, solver_cfg)
        if prep[0] in ("tlp", "sch"):
            # Component-plane layouts: the Krylov space lives in plane-major
            # vectors; convert the RHS in and the solution out ONCE per
            # solve (dots/axpys inside GMRES are layout-agnostic).
            from navierstokes_tpu.ops.plane_dia import from_planes, to_planes

            nb, nbp = (prep[6], prep[7]) if prep[0] == "tlp" \
                else (prep[5], prep[6])
            res = self._solve_prepared_raw(
                prep, to_planes(rhs, nb, nbp), solver_cfg
            )
            return res._replace(x=from_planes(res.x, nb, nbp))
        return self._solve_prepared_raw(prep, rhs, solver_cfg)

    def _solve_prepared_raw(self, prep, rhs, solver_cfg):
        matvec, b_prep, _ = self._prep_operators(prep)
        b_eff = b_prep(rhs)

        if solver_cfg.method == "cg":
            # For SPD sub-problems routed through the same machinery; the
            # NS saddle-point system itself is indefinite — use gmres.
            from navierstokes_tpu.solvers.cg import cg

            res = cg(
                matvec, b_eff, rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter,
            )
            return GMRESResult(
                x=res.x, iters=res.iters, resnorm=res.resnorm,
                converged=res.converged,
            )
        if solver_cfg.method == "ca_gmres":
            from navierstokes_tpu.solvers.sstep import ca_gmres

            # Newton-basis shifts exist only for the constant exact-Jacobian
            # operator (built in _ensure_prepared); the Stokes solve runs
            # before preparation and stays monomial by construction.
            shifts = getattr(self, "_ca_shifts", None) \
                if solver_cfg.ca_basis == "newton" else None
            return ca_gmres(
                matvec, b_eff, basis=min(solver_cfg.restart, 16),
                rtol=solver_cfg.rtol, atol=solver_cfg.atol,
                maxiter=solver_cfg.maxiter, shifts=shifts,
            )
        return gmres(
            matvec, b_eff, restart=solver_cfg.restart,
            rtol=solver_cfg.rtol, atol=solver_cfg.atol,
            maxiter=solver_cfg.maxiter,
        )

    # -- Stokes initialization ----------------------------------------------

    def _stokes_dia(self, consts):
        """Jitted: the BC-applied Stokes operator in DIA form (`:617-662`)."""
        from navierstokes_tpu.sparse.dia import zero_rows_dia

        d, cfg = self.disc, self.cfg
        dummy_UL = jnp.zeros((d.ne, 3, 4), dtype=self.dtype)
        # Stokes uses the small Stokes Reynolds number (`:1038`).
        stokes_dia = self._assemble_dia_c(
            consts, dummy_UL, STOKES_TERMS, cfg.stokes_reynolds
        )
        return zero_rows_dia(
            d.dia_pattern.offsets, stokes_dia, consts["bc_is_bc"]
        )

    def _stokes_solve(self, prep_arrays, rhs):
        """Jitted: the Stokes solve on an already-prepared operator.

        The static prep parts come from `self._stokes_prep_static` (set by
        `stokes_init` before the first trace — same closure discipline as
        the Newton step's `self._prep_static`)."""
        res = self._solve_prepared(
            _merge_prep(self._stokes_prep_static, prep_arrays), rhs,
            self.cfg.stokes_krylov,
        )
        return res.x, res.iters, res.converged

    def stokes_init(self):
        """Initial condition from the steady Stokes solve (`:1094-1095`).

        Three phases — jitted assembly, EAGER operator preparation, jitted
        solve — so the preparation (which may include a host-side dense
        coarse inverse at nc > 8192, see solvers/coarse.py) runs outside
        the solve executable, and the solve program's compile-time temps
        exclude the O(nc^2)-memory inverse pipeline."""
        stokes_dia = self._stokes_assemble_jit(self._consts)
        static, arrays = _split_prep(self._prepare_operator_dia(stokes_dia))
        self._stokes_prep_static = static
        u0, iters, conv = self._stokes_jit(arrays, self._stokes_rhs)
        return u0

    @property
    def _stokes_rhs(self):
        return self.disc.bc.value.astype(self.dtype)

    # -- Newton time step ---------------------------------------------------

    def _newton_step(self, u_init, u_old, delta_u_init, consts):
        d, cfg = self.disc, self.cfg
        nw = cfg.newton
        kv = cfg.krylov
        max_newton = nw.max_iter
        dtype = self.dtype

        offsets = d.dia_pattern.offsets
        is_bc = consts["bc_is_bc"]
        bc_value = consts["bc_value"]

        plane_res = cfg.residual == "operator" and self._res_planes
        if plane_res:
            from navierstokes_tpu.ops.plane_dia import (
                from_planes,
                node_offsets_from_scalar,
                spmv_planes,
                to_planes,
            )

            noffs = node_offsets_from_scalar(offsets)
            nb = d.mesh.nv
            nbp = consts["res_A"].shape[2]
            # u_old is fixed for the step: convert once at trace level.
            uold_p = to_planes(u_old.astype(dtype), nb, nbp)

        def residual(u):
            if plane_res:
                f = spmv_planes(noffs, consts["res_A"],
                                to_planes(u, nb, nbp)) \
                    - spmv_planes(noffs, consts["res_M"], uold_p)
                return from_planes(f, nb, nbp)
            if cfg.residual == "operator":
                return spmv_dia(offsets, consts["res_A"], u) - spmv_dia(
                    offsets, consts["res_M"], u_old
                )
            return assemble_residual(
                consts["tets"], consts["vol"], consts["grad"], consts["h"],
                u, u_old, cfg.dt, cfg.reynolds, cfg.delta, ndof=d.ndof,
            )

        du_tol = nw.atol if nw.du_tol is None else nw.du_tol

        def check(u, delta_u):
            """BC-insert + residual + convergence flags (one Newton 'check').

            Returns the post-insert state so the loop carry always holds
            BC-consistent iterates."""
            u = jnp.where(is_bc, bc_value.astype(dtype), u)
            F = jnp.where(is_bc, jnp.zeros((), dtype), residual(u))
            res_norm = jnp.linalg.norm(F)
            du_norm = jnp.linalg.norm(delta_u)
            return u, F, res_norm, du_norm

        # The solve is UNCONDITIONAL inside the body and convergence gates
        # loop ENTRY (a do-while): a skip-branch would only fire on the
        # exit iteration, so it buys nothing.
        def body(carry):
            (u, F, delta_u, it, res0, res_h, du_h, lin_total, _, _) = carry
            prev_rn = res_h[it]          # set by the previous iteration/init

            if cfg.jacobian == "exact":
                prep = _merge_prep(self._prep_static, consts["prep"])
                sol = self._solve_prepared(prep, -F, kv)
            else:
                from navierstokes_tpu.sparse.dia import zero_rows_dia

                UL, _ = local_fields(consts["tets"], u)
                jnl = self._assemble_dia_c(
                    consts, UL, NONLINEAR_TERMS, cfg.reynolds
                )
                values = zero_rows_dia(
                    offsets, consts["jlin_dia"] + jnl, is_bc
                )
                sol = self._solve_prepared(
                    self._prepare_operator_dia(values), -F, kv
                )
            u, delta_u, lin_total = u + sol.x, sol.x, lin_total + sol.iters

            u, F, res_norm, du_norm = check(u, delta_u)
            it = it + 1
            res_h = res_h.at[it].set(res_norm)       # index==max drops (OOB)
            du_h = du_h.at[it].set(du_norm)
            converged = (
                (res_norm < nw.rtol * res0) | (res_norm < nw.atol)
            ) & (du_norm < du_tol)
            # Stagnation (the reference's break, src/solve_newton.c:
            # 1275-1278): tiny update, OR no residual progress.  The
            # no-progress exit matters in f32 on settled steps whose entry
            # residual sits at the dtype floor just above atol: every
            # linear solve then converges in its own (preconditioned)
            # norm while F barely moves, and without this test Newton
            # burns max_newton iterations certifying nothing (measured at
            # matrix 3: newton=30, ~220 lin iters on settled steps, with
            # bit-identical solutions to the it=2 exit).  The exit is GATED
            # TO f32: in f64 jacobian="reference" mode Newton is a fixed-
            # point iteration (the assembled convection Jacobian is not the
            # true Jacobian of the linear residual) whose early progress can
            # legitimately be <10%/iter, so f64 keeps the reference's
            # tiny-|du| break only (src/solve_newton.c:1275-1278); pinned by
            # test_newton_e2e.py::test_f64_slow_convergence_not_truncated.
            stagnated = (it > 5) & (du_norm < nw.stol)
            if dtype == jnp.float32:
                stagnated = stagnated | (
                    (it > 2) & (res_norm >= 0.9 * prev_rn)
                )
            return (
                u, F, delta_u, it, res0, res_h, du_h, lin_total,
                converged, stagnated,
            )

        def cond(carry):
            (_, _, _, it, _, _, _, _, converged, stagnated) = carry
            return (it < max_newton) & (~converged) & (~stagnated)

        u0, F0, rn0, dun0 = check(
            u_init.astype(dtype), delta_u_init.astype(dtype)
        )
        converged0 = ((rn0 < nw.rtol * rn0) | (rn0 < nw.atol)) & (
            dun0 < du_tol
        )
        nanarr = jnp.full(max_newton, jnp.nan, dtype=dtype)
        init = (
            u0, F0, delta_u_init.astype(dtype), jnp.int32(0), rn0,
            nanarr.at[0].set(rn0), nanarr.at[0].set(dun0), jnp.int32(0),
            converged0, jnp.asarray(False),
        )
        (u, _, delta_u, it, _, res_h, du_h, lin_total, converged, _) = (
            jax.lax.while_loop(cond, body, init)
        )
        stats = NewtonStats(
            iters=jnp.minimum(it + 1, max_newton), converged=converged,
            res_hist=res_h, du_hist=du_h, lin_iters=lin_total,
        )
        return u, delta_u, stats

    def step(self, u, u_old, delta_u):
        """One backward-Euler step. Returns (u_new, delta_u, stats)."""
        self._ensure_prepared()
        return self._step_jit(u, u_old, delta_u, self._step_consts)

    # -- Driver -------------------------------------------------------------

    def run(
        self,
        n_steps: Optional[int] = None,
        *,
        u0=None,
        save_dir: Optional[str] = None,
        save_every: Optional[int] = None,
        write_vtu_files: bool = False,
        monitor: bool = True,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 0,
        check_finite: bool = False,
        start_step: int = 0,
        delta_u0=None,
    ):
        """Full transient run mirroring the reference CLI semantics
        (`-save` => per-step `res/solution_stepNNNN.dat`).

        Resume support (capability the reference lacks — SURVEY.md §5):
        `start_step` continues global step numbering for dumps/checkpoints
        and `delta_u0` warm-starts the first Newton solve, so a resumed run
        is bit-identical to the uninterrupted one (same jitted step on the
        same state)."""
        cfg = self.cfg
        n_steps = cfg.n_steps if n_steps is None else n_steps
        save_every = cfg.save_every if save_every is None else save_every

        if u0 is None:
            u0 = self.stokes_init()
        if (cfg.jacobian == "exact" and cfg.residual == "operator"
                and self.disc.ndof >= 1_000_000
                and self.disc.dia_elem_map is not None):
            # Above ~1M rows the assembly arrays (elem scatter map alone is
            # ~3.5 GB at 2.35M rows) crowd out the step's working set; the
            # exact/operator step never reads them.
            self.release_assembly_buffers()
        u = jnp.asarray(u0, dtype=self.dtype)
        u_old = u
        delta_u = jnp.zeros_like(u) if delta_u0 is None else \
            jnp.asarray(delta_u0, dtype=self.dtype)

        pvd_entries = []
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)

        def print_monitor(step, stats):
            it = int(stats.iters)
            res_h = np.asarray(stats.res_hist)
            print(
                f"=== Time step {step} (t={step * cfg.dt:.3f}) === "
                f"newton={it} lin={int(stats.lin_iters)} "
                f"|F|={res_h[max(it - 1, 0)]:.2e} "
                f"converged={bool(stats.converged)}"
            )
            if monitor == "newton":
                # Per-iteration lines in the reference monitor format
                # (`src/solve_newton.c:1235-1239`).
                du_h = np.asarray(stats.du_hist)
                for k in range(it):
                    rel = res_h[k] / max(res_h[0], 1e-300)
                    tag = "CONVERGED" if (
                        k == it - 1 and bool(stats.converged)
                    ) else ""
                    print(
                        f"Newton {k:02d}: |F|={res_h[k]:6.2e} "
                        f"(rel {rel:.1e}), |du|={du_h[k]:6.2e} {tag}"
                    )

        pending = None   # (step, stats) whose monitor print is deferred
        for step in range(start_step + 1, start_step + n_steps + 1):
            u, delta_u, stats = self.step(u, u_old, delta_u)
            if monitor:
                # Pipelined monitor: step N+1 is dispatched BEFORE step N's
                # stats are fetched, so the host round trips (4 per step)
                # overlap device compute instead of serializing with it.
                if pending is not None:
                    print_monitor(*pending)
                pending = (step, stats)
            if check_finite and not bool(jnp.all(jnp.isfinite(u))):
                # Failure detection (the `src/main.c:172-179` NaN-abort
                # analog): stop before writing poisoned state.
                raise FloatingPointError(
                    f"non-finite state detected at step {step}; aborting "
                    "(check dt/Re/tolerances)"
                )
            if save_dir and save_every and step % save_every == 0:
                dat = os.path.join(save_dir, f"solution_step{step:04d}.dat")
                write_petsc_vec(dat, np.asarray(u))
                if write_vtu_files:
                    vtu = f"solution_{step:04d}.vtu"
                    write_vtu(os.path.join(save_dir, vtu), self.disc.mesh, u)
                    pvd_entries.append((step, vtu))
            if checkpoint_path and checkpoint_every and step % checkpoint_every == 0:
                from navierstokes_tpu.io.checkpoint import save_checkpoint

                # A checkpoint at the END of step N stores the state the
                # next step starts from: u_old becomes u.  Fingerprint the
                # user-level config (NOT the coarse-resolved self.cfg): the
                # resume path validates against the config the caller holds.
                save_checkpoint(
                    checkpoint_path, cfg=self.user_cfg, step=step, u=np.asarray(u),
                    u_old=np.asarray(u), delta_u=np.asarray(delta_u),
                )
            u_old = u

        if pending is not None:
            print_monitor(*pending)
        if save_dir and pvd_entries:
            write_pvd(os.path.join(save_dir, "time_series.pvd"), pvd_entries)
        return u
