"""Config resolution: the measured coarse-aggregate auto schedule.

Pins the size->agg table (the swept per-size schedule)
so the tuned per-size step times ARE what a default user gets (the runtime
variant-dispatch discipline of the reference's
`src/kernels/variant_selector.c:3-15`).
"""

import dataclasses

import pytest

from navierstokes_tpu.config import (
    AUTO_COARSE_DENSE_CAP,
    NSConfig,
    SolverConfig,
    auto_coarse_agg,
    resolve_coarse_defaults,
)


@pytest.mark.parametrize(
    "ndof,agg",
    [
        (4 * 3, 48),            # tiny CPU meshes
        (117_500, 48),          # matrix 6
        (150_000, 48),
        (150_004, 128),
        (511_024, 128),         # matrix 8
        (600_000, 128),
        (998_784, 256),         # matrix 9
        (2_348_992, 256),       # matrix 10
    ],
)
def test_auto_coarse_agg_schedule(ndof, agg):
    assert auto_coarse_agg(ndof) == agg


def test_resolve_fills_both_krylov_configs():
    cfg = NSConfig(krylov=SolverConfig(preconditioner="two_level"))
    assert cfg.krylov.coarse_agg is None
    nv = 511_024 // 4
    r = resolve_coarse_defaults(cfg, nv)
    assert r.krylov.coarse_agg == 128
    assert r.stokes_krylov.coarse_agg == 128
    # nc = 4*ceil(nv/128) = 3996 fits the 4096 default: dense_max untouched
    assert r.krylov.coarse_dense_max == 4096


def test_resolve_raises_dense_max_for_scheduled_agg():
    # matrix 10: agg=256 -> nc=9176 > 4096; the tuned config is DENSE,
    # so auto must lift dense_max to fit.
    nv = 2_348_992 // 4
    r = resolve_coarse_defaults(NSConfig(), nv)
    agg = r.krylov.coarse_agg
    nc = 4 * (-(-nv // agg))
    assert agg == 256 and nc == 9176
    assert r.krylov.coarse_dense_max == nc <= AUTO_COARSE_DENSE_CAP


def test_resolve_never_touches_explicit_values():
    cfg = NSConfig(
        krylov=SolverConfig(coarse_agg=64, coarse_dense_max=8192)
    )
    r = resolve_coarse_defaults(cfg, 2_348_992 // 4)
    assert r.krylov.coarse_agg == 64
    assert r.krylov.coarse_dense_max == 8192


def test_resolve_respects_dense_cap():
    # Huge mesh: nc at agg=256 exceeds the cap -> dense_max stays put and
    # the multilevel path takes over (never auto-build a >1 GB inverse).
    nv = 40_000_000
    r = resolve_coarse_defaults(NSConfig(), nv)
    nc = 4 * (-(-nv // r.krylov.coarse_agg))
    assert nc > AUTO_COARSE_DENSE_CAP
    assert r.krylov.coarse_dense_max == 4096


def test_solver_resolves_auto_agg():
    """The model resolves coarse_agg=None at construction."""
    from navierstokes_tpu.mesh.box import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = channel_mesh(3, 2, 2)
    krylov = SolverConfig(preconditioner="two_level")
    cfg = NSConfig(dt=0.01, krylov=krylov,
                   stokes_krylov=krylov, dtype="float64")
    s = NavierStokesSolver(mesh, cfg)
    assert s.cfg.krylov.coarse_agg == 48
    assert s.cfg.stokes_krylov.coarse_agg == 48


def test_unknown_coarse_basis_rejected():
    from navierstokes_tpu.mesh.box import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver

    mesh = channel_mesh(3, 2, 2)
    krylov = SolverConfig(preconditioner="two_level", coarse_agg=4,
                          coarse_basis="Linear")   # typo'd case
    cfg = NSConfig(dt=0.01, krylov=krylov, stokes_krylov=krylov,
                   dtype="float64")
    s = NavierStokesSolver(mesh, cfg)
    with pytest.raises(ValueError, match="coarse_basis"):
        s._ensure_prepared()


def test_replace_keeps_auto():
    # dataclasses.replace with unrelated overrides must not lose the None
    sc = dataclasses.replace(SolverConfig(), restart=60)
    assert sc.coarse_agg is None


# -- preconditioner="auto": the measured per-size schedule (round 5) ---------


@pytest.mark.parametrize(
    "ndof,precond,knob,deg",
    [
        (4 * 3, "two_level", "coarse_cheby", 3),        # tiny CPU meshes
        (117_500, "two_level", "coarse_cheby", 3),      # matrix 6
        (150_000, "two_level", "coarse_cheby", 3),
        (150_004, "schur", "schur_v_cheby", 2),
        (511_024, "schur", "schur_v_cheby", 2),         # matrix 8
        (2_348_992, "schur", "schur_v_cheby", 2),       # matrix 10
    ],
)
def test_auto_preconditioner_schedule(ndof, precond, knob, deg):
    from navierstokes_tpu.config import auto_preconditioner

    upd = auto_preconditioner(ndof)
    assert upd["preconditioner"] == precond
    assert upd[knob] == deg


def _auto_cfg(**krylov_kw):
    kw = {"spmv": "plane", **krylov_kw}
    kr = SolverConfig(preconditioner="auto", **kw)
    return NSConfig(krylov=kr, stokes_krylov=kr)


def test_resolve_auto_small_and_large():
    r = resolve_coarse_defaults(_auto_cfg(), 117_500 // 4)
    assert r.krylov.preconditioner == "two_level"
    assert r.krylov.coarse_cheby == 3
    r = resolve_coarse_defaults(_auto_cfg(), 511_024 // 4)
    assert r.krylov.preconditioner == "schur"
    assert r.krylov.schur_v_cheby == 2
    assert r.stokes_krylov.preconditioner == "schur"


def test_resolve_auto_degrades_off_the_eager_path():
    # The scheduled winners need jacobian='exact'; anything else gets the
    # round-4 flagship (plain two_level), never an invalid combination.
    cfg = dataclasses.replace(_auto_cfg(), jacobian="reference")
    r = resolve_coarse_defaults(cfg, 511_024 // 4)
    assert r.krylov.preconditioner == "two_level"
    assert r.krylov.coarse_cheby == 0
    # Schur tier additionally needs spmv='plane' / no deflation / 1 chip.
    for bad in (dict(spmv="xla"), dict(deflation_k=8)):
        r = resolve_coarse_defaults(_auto_cfg(**bad), 511_024 // 4)
        assert r.krylov.preconditioner == "two_level", bad
    r = resolve_coarse_defaults(_auto_cfg(), 511_024 // 4, single_chip=False)
    assert r.krylov.preconditioner == "two_level"
    assert r.krylov.coarse_cheby == 0
    r = resolve_coarse_defaults(_auto_cfg(), 117_500 // 4, single_chip=False)
    assert r.krylov.preconditioner == "two_level"
    assert r.krylov.coarse_cheby == 0


def test_resolve_auto_respects_pinned_degrees():
    r = resolve_coarse_defaults(_auto_cfg(coarse_cheby=5), 117_500 // 4)
    assert r.krylov.coarse_cheby == 5
    r = resolve_coarse_defaults(_auto_cfg(schur_v_cheby=4), 511_024 // 4)
    assert r.krylov.schur_v_cheby == 4


def test_solver_resolves_auto_preconditioner():
    """End to end: a tiny mesh with the run.py flagship defaults builds a
    two_level+cheby solver single-chip and a plain two_level distributed."""
    import jax

    from navierstokes_tpu.mesh.box import channel_mesh
    from navierstokes_tpu.model import NavierStokesSolver
    from navierstokes_tpu.parallel import DistributedNavierStokesSolver
    from navierstokes_tpu.run import default_f32_krylov

    kr = dataclasses.replace(default_f32_krylov(), coarse_agg=4)
    assert kr.preconditioner == "auto"
    cfg = NSConfig(dt=0.01, krylov=kr, stokes_krylov=kr, dtype="float64")
    mesh = channel_mesh(6, 2, 2)
    s = NavierStokesSolver(mesh, cfg)
    assert s.cfg.krylov.preconditioner == "two_level"
    assert s.cfg.krylov.coarse_cheby == 3
    assert s.user_cfg.krylov.preconditioner == "auto"   # checkpoint contract
    d, _ = DistributedNavierStokesSolver.from_mesh(
        mesh, cfg, devices=jax.devices()[:2]
    )
    assert d.cfg.krylov.preconditioner == "two_level"
    assert d.cfg.krylov.coarse_cheby == 0
