"""Typed configuration for the Navier–Stokes engine.

The reference hardcodes physics/numerics constants in each `main()`
(`src/solve_newton.c:929-940`, `src/solve_newton-petsc.c:663-672`) and exposes
the rest through the PETSc options database.  Here everything lives in one
dataclass tree so a run is fully described by a single `NSConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver settings (the `KSPSetTolerances`/`KSPGMRESSetRestart` analog).

    Mirrors the reference's Newton KSP: GMRES(30) with rtol 1e-10 / atol 1e-12
    (`src/solve_newton.c:1154-1163`) and the Stokes KSP: GMRES with
    rtol/atol 1e-12 (`src/solve_newton.c:1066-1076`).
    """

    method: str = "gmres"           # "gmres" | "cg"
    restart: int = 30               # GMRES restart length m
    rtol: float = 1e-10
    atol: float = 1e-12
    maxiter: int = 2000
    preconditioner: str = "block_jacobi"  # "block_jacobi" | "two_level" |
                                          # "schur" | "ilu0" | "none" |
                                          # "auto".
                                          # "schur" = SIMPLE-style block-
                                          # triangular pressure-Schur
                                          # preconditioner (solvers/
                                          # schur.py): velocity two-grid +
                                          # approximate Schur two-grid.
                                          # Requires spmv='plane' +
                                          # jacobian='exact'; single-chip.
                                          # "auto" = the measured per-size
                                          # schedule (auto_preconditioner),
                                          # resolved at solver construction
                                          # — the run.py flagship default.
    # The f32 CLI default is preconditioner="auto" (run.default_f32_krylov);
    # this dataclass default stays block_jacobi because it needs no
    # aggregation parameters and is the right pick for small/CPU runs.
    neumann_order: int = 2      # Neumann-series boost of block-Jacobi (0 = plain)
                                # NOTE: the Neumann series need not converge on
                                # the indefinite saddle-point system (odd orders
                                # can diverge); prefer "two_level" for strength
    coarse_agg: Optional[int] = None  # nodes per aggregate (two_level).
                                # None = auto: the swept size schedule
                                # (48 @<=150k rows, 128 @<=600k, 256 above —
                                # config.auto_coarse_agg), resolved
                                # against the mesh at
                                # solver construction (config.
                                # resolve_coarse_defaults); pass an int to
                                # pin it (the CLI --coarse-agg override).
    coarse_shift: float = 1e-6  # diagonal shift on the coarse operator
    coarse_ml_smooth: int = 1   # multilevel coarse: level-1 block-Jacobi
                                # smoothing sweeps per two-grid cycle
    coarse_ml_cycles: int = 1   # multilevel coarse: two-grid cycles per
                                # apply (each = level-2 dense correction +
                                # coarse_ml_smooth Jacobi sweeps); cheap at
                                # coarse size, directly buys outer Krylov
                                # iterations at 511k+ rows
    coarse_ml_damp: float = 1.0  # damping on the level-1 Jacobi sweeps.
                                # UNDAMPED block-Jacobi on the indefinite
                                # saddle-point coarse system diverges
                                # (measured: smooth>=2 at 511k rows maxes
                                # Newton out); <=0.5 is the stable choice
                                # when smoothing is enabled
    coarse_basis: str = "const"  # coarse-space basis per aggregate:
                                # "const" = piecewise-constant per
                                # component (4 dofs/aggregate); "linear" =
                                # orthonormalized {1, x, y, z} per
                                # component (16 dofs/aggregate) — same
                                # dense nc with 4x-larger aggregates and a
                                # richer space (O(h^2) vs O(h) smooth-error
                                # approximation).  linear requires
                                # spmv='plane' + dense coarse + eager prep.
    coarse_smooth_omega: float = 0.0  # smoothed-aggregation prolongator
                                # P = (I - omega*D^{-1}A) P0 (0 = plain
                                # piecewise-constant aggregation): +1 SpMV
                                # + 1 D^{-1} per coarse apply; Galerkin
                                # matrix corrected on host at prep time.
                                # MEASURED NEGATIVE RESULT on this
                                # indefinite saddle-point operator: ~3x
                                # more iterations in f64 at matrix 3 and
                                # outright stagnation at 117k+ for every
                                # omega tried (0.5/0.6667/1.0 — classic SA
                                # assumes SPD).  Keep 0.0.
                                # (solvers.coarse.smoothed_coarse_dense_
                                # matrix).  Dense coarse + exact-Jacobian
                                # (eager prep) only.
    coarse_cheby: int = 0       # two_level post-smoother: 0 = one damped-
                                # Jacobi application (default); d >= 1 = a
                                # degree-d Chebyshev polynomial in the
                                # Jacobi-preconditioned operator D^{-1}A
                                # over [f*lmax, 1.05*lmax] (the classic AMG
                                # polynomial smoother).  lmax is estimated
                                # ONCE at operator preparation by a short
                                # Arnoldi sweep — requires eager prep
                                # (jacobian='exact'); single-chip only.
                                # Each extra degree costs one SpMV + one
                                # D^{-1} per preconditioner apply.  NOTE:
                                # classic Chebyshev theory assumes a
                                # positive-real spectrum; the NS saddle
                                # point is indefinite — measure, don't
                                # assume.
    coarse_cheby_fraction: float = 0.3  # lower end of the smoothing
                                # interval as a fraction of lmax (the
                                # "cheby fraction" knob of hypre/ML); the
                                # coarse grid is expected to handle modes
                                # below it
    schur_cheby: int = 2        # preconditioner='schur': Chebyshev degree
                                # of the S_hat (pressure Schur) smoother;
                                # 0 = one Jacobi application.  S_hat =
                                # D + B diag(F)^{-1} B^T is ~SPD, so the
                                # Chebyshev interval ([coarse_cheby_
                                # fraction * lmax, 1.05 lmax], lmax from
                                # host power iteration at prep time) is on
                                # solid theory here — unlike the coupled
                                # saddle point.
    schur_v_cheby: int = 0      # preconditioner='schur': Chebyshev degree
                                # of the velocity (F-block) smoother; 0 =
                                # one block-Jacobi (3x3 diag) application.
                                # Each extra degree costs one F apply
                                # (~9/16 of a full SpMV).
    schur_shape: str = "lower"  # "lower" = block lower-triangular (one
                                # velocity solve + one Schur solve per
                                # apply); "full" adds the B^T velocity
                                # correction z_u -= F_hat^{-1} B^T z_p
                                # (a second velocity solve + one 3x1
                                # apply — LDU quality at ~1.6x the cost)
    coarse_dense_max: int = 4096  # max coarse DoF for the dense inverse;
                                # beyond it the coarse level is kept sparse
                                # (DIA) and corrected by a SECOND, smaller
                                # aggregation level whose operator is
                                # inverted densely — the scalable multilevel
                                # path (a dense nc x nc inverse is O(nc^2)
                                # memory / O(nc^3) setup: 452 MB at 511k
                                # rows, 9.6 GB at 2.35M)
    spmv: str = "auto"          # "auto" | "xla" | "plane": auto and xla
                                # apply the scalar-DIA operator
                                # (ops.spmv.spmv_dia).  "plane" =
                                # component-plane operator layout
                                # (by-component DoF ordering,
                                # ops.plane_dia): 0.74x the operator bytes
                                # (bench/layout_census.py); used by the
                                # two_level and schur preconditioners
    deflation_k: int = 0        # GCRO-style recycled subspace size: k
                                # harmonic-Ritz vectors of the
                                # preconditioned operator, computed ONCE at
                                # operator preparation (the exact-Jacobian
                                # operator is constant across Newton
                                # iterations and time steps) and projected
                                # out of every GMRES solve
                                # (solvers/deflation.py).  0 = off.
                                # Requires jacobian='exact' +
                                # method='gmres'; single-chip only.
    deflation_arnoldi: int = 0  # Arnoldi length for the recycle setup;
                                # 0 = auto (max(3k, 48))
    ca_basis: str = "monomial"  # method='ca_gmres' basis polynomial:
                                # "monomial" (v, Av, A^2 v, ...) or
                                # "newton" — Leja-ordered shifted products
                                # (A - theta_i) with theta_i the Ritz
                                # values of the preconditioned operator
                                # from a prepare-time Arnoldi sweep
                                # (solvers.sstep.newton_shifts).  The
                                # monomial basis conditions like kappa^m
                                # and stalls in f32 at 117k rows; newton is
                                # the textbook fix.  Requires jacobian='exact'
                                # (shifts of the constant operator);
                                # single-chip.
    matvec_dtype: Optional[str] = None  # e.g. "bfloat16": store the scaled
                                    # operator in low precision (halves SpMV
                                    # memory traffic; Krylov vectors stay in
                                    # the run dtype). Only sensible when rtol is
                                    # well above bf16 epsilon (~8e-3 per op,
                                    # GMRES tolerates inexact matvecs).


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton iteration controls (`src/solve_newton.c:936-940`)."""

    rtol: float = 1e-6
    atol: float = 1e-8
    stol: float = 1e-10             # stagnation threshold on |du|
    max_iter: int = 30
    du_tol: Optional[float] = None  # |du| threshold in the convergence test;
                                    # None = atol (exact reference semantics,
                                    # `src/solve_newton.c:1231-1232`); set
                                    # explicitly for float32 runs where
                                    # |du| bottoms out near sqrt(n)*eps*|u|


@dataclasses.dataclass(frozen=True)
class NSConfig:
    """Full problem description.

    Defaults follow the golden-corpus run (`src/solve_newton-petsc.c:663-667`):
    dt = 1e-3, T = 1 (1000 steps), Re = 300, delta = 0.05.
    """

    dt: float = 1e-3
    t_final: float = 1.0
    reynolds: float = 300.0
    delta: float = 0.05             # Brezzi–Pitkaranta stabilization parameter
    stokes_reynolds: float = 0.01   # Re used for the Stokes initializer
                                    # (`src/solve_newton.c:1038`)

    newton: NewtonConfig = dataclasses.field(default_factory=NewtonConfig)
    krylov: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    stokes_krylov: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(rtol=1e-12, atol=1e-12, maxiter=1000)
    )

    # Numerics
    dtype: str = "float32"          # compute dtype on-device
    assembly_dtype: str = "float64" # host-side element precompute dtype
    residual: str = "operator"      # "operator" | "elementwise".
    # "operator": F = A_lin u - (M/dt) u_old as two DIA SpMVs (~0.1 ms)
    # using the precomputed constant operators — valid because the
    # reference residual is linear in u (convection cancels identically).
    # "elementwise": per-element evaluation + scatter, the literal
    # re-expression of `compute_residual_optimized`
    # (`src/solve_newton.c:284-386`); much slower, kept as the parity
    # oracle.  Both agree to roundoff (tested).
    jacobian: str = "exact"         # "exact" | "reference".
    # The reference residual is LINEAR in u — its convection terms cancel
    # identically (see tests/test_elements.py::test_convection_cancellation
    # _quirk) — while its iteration matrix re-adds convection
    # (`src/solve_newton.c:1245-1246`), turning Newton into a slowly
    # contracting fixed-point iteration.  Both modes converge to the SAME
    # state (the residual's root); "exact" uses the residual's true (linear,
    # constant) Jacobian, pre-scaled once at setup, so each time step costs
    # ~one Krylov solve.  "reference" reproduces the reference's iteration
    # trajectory for parity studies.

    # Sparse layout
    ell_slots: Optional[int] = None  # max 4x4 blocks per block-row; None = derive

    # Output
    save_every: int = 0             # 0 = never; N = every N steps
    output_dir: str = "res"

    @property
    def n_steps(self) -> int:
        return int(round(self.t_final / self.dt))

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def assembly_jnp_dtype(self):
        return jnp.dtype(self.assembly_dtype)


def auto_coarse_agg(ndof: int) -> int:
    """Two_level aggregate-size schedule (swept winners: agg=48 at matrix
    6, 128 at matrix 8, 256 at matrices 9-10).  The coarse space is
    non-monotone in agg on the saddle-point operator, so these are swept
    values, not a formula — re-sweep before extending the table."""
    if ndof <= 150_000:
        return 48
    if ndof <= 600_000:
        return 128
    return 256


# Dense coarse inverses beyond this many coarse DoF are never auto-selected
# (nc=16384 is a 1 GB f32 inverse; past it the multilevel path is the design).
AUTO_COARSE_DENSE_CAP = 16_384


def auto_preconditioner(ndof: int) -> dict:
    """Preconditioner schedule (swept at matrices 6/8/9/10): the coupled
    two_level cycle with a degree-3 Chebyshev post-smoother at mmesh scale,
    and the pressure-Schur block preconditioner with a degree-2 Chebyshev
    velocity smoother above it, where linear-iteration growth with size is
    flatter (42 -> 90 linear iterations per step over 117k -> 2.35M rows,
    against 69 -> 253 for two_level).  The tier boundary reuses
    auto_coarse_agg's first tier; both tables are swept values, not
    formulas — re-sweep on the GPU before extending."""
    if ndof <= 150_000:
        return {"preconditioner": "two_level", "coarse_cheby": 3}
    return {"preconditioner": "schur", "schur_v_cheby": 2}


def resolve_coarse_defaults(cfg: NSConfig, nv: int,
                            single_chip: bool = True) -> NSConfig:
    """Resolve the "auto" preconditioner and coarse_agg=None to the measured
    size schedules.

    preconditioner="auto" picks the per-size winner (auto_preconditioner)
    when the config can run it: the scheduled choices need eager operator
    preparation (jacobian='exact'), the Schur tier additionally needs
    spmv='plane', no deflation, and a single chip — anything else degrades
    to the round-4 flagship (plain two_level), which every path supports.
    Smoother knobs the user set explicitly (nonzero coarse_cheby /
    schur_v_cheby) are never overridden.

    Also raises coarse_dense_max to fit the scheduled aggregation when the
    resulting coarse space is dense-invertible (<= AUTO_COARSE_DENSE_CAP):
    the tuned m9/m10 configurations are dense at nc ~4-9k, above the 4096
    dataclass default.  Explicit coarse_agg/coarse_dense_max values are
    never touched (the CLI/sweep override contract)."""
    import dataclasses as _dc

    def fix_precond(sc: SolverConfig) -> SolverConfig:
        if sc.preconditioner != "auto":
            return sc
        upd = dict(auto_preconditioner(4 * nv))
        if cfg.jacobian != "exact":
            upd = {"preconditioner": "two_level"}    # cheby/schur need eager prep
        elif upd["preconditioner"] == "schur" and (
                not single_chip or sc.spmv != "plane" or sc.deflation_k):
            upd = {"preconditioner": "two_level"}
        elif not single_chip:
            upd = {"preconditioner": "two_level"}    # coarse_cheby: 1-chip only
        for knob in ("coarse_cheby", "schur_v_cheby"):
            if getattr(sc, knob) and knob in upd:
                del upd[knob]                        # user pinned the degree
        return _dc.replace(sc, **upd)

    def fix(sc: SolverConfig) -> SolverConfig:
        sc = fix_precond(sc)
        if sc.coarse_agg is not None:
            return sc
        agg = auto_coarse_agg(4 * nv)
        updates = {"coarse_agg": agg}
        nc = 4 * (-(-nv // agg))
        if sc.coarse_basis == "const" and \
                sc.coarse_dense_max < nc <= AUTO_COARSE_DENSE_CAP:
            updates["coarse_dense_max"] = nc
        return _dc.replace(sc, **updates)

    return _dc.replace(
        cfg, krylov=fix(cfg.krylov), stokes_krylov=fix(cfg.stokes_krylov)
    )
