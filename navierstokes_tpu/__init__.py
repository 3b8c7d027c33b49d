"""navierstokes_tpu — an incompressible Navier–Stokes FEM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C/PETSc solver `aantoine890/navierstokes` (see SURVEY.md):

- P1–P1 stabilized tetrahedral FEM for transient incompressible Navier–Stokes
  (4 DoF per node: u_x, u_y, u_z, p; Brezzi–Pitkäranta pressure stabilization),
- backward-Euler time stepping with exact-Jacobian Newton linearization,
- blocked-sparse (4x4 node blocks) operators in scalar-DIA and
  component-plane layouts, with block-ELL / BCSR oracles,
- SpMV / matrix-powers (A^k x) / SpMM as plain `jax.numpy`,
- Krylov solvers (CG, GMRES(m)) as jitted `lax.while_loop`s with block-Jacobi
  and ILU(0) preconditioning,
- multi-chip domain decomposition via `shard_map` with halo exchange,
- PETSc-ASCII-compatible `.dat` solution output for regression against the
  reference's golden corpus.
"""

from navierstokes_tpu.config import NSConfig, SolverConfig

__version__ = "0.1.0"

__all__ = ["NSConfig", "SolverConfig", "__version__"]
