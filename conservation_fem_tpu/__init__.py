"""conservation_fem_tpu — finite-element conservation-law framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
alleswe2k/Conservation-FEM (the FEniCSx reference): scalar hyperbolic
conservation laws in 2D, continuous P1-P3 Lagrange FEM, stabilized by
residual-viscosity (RV) and smoothness-indicator (SI) artificial viscosity,
plus the compressible-Euler / incompressible Navier-Stokes prototypes.

Design (array-first, not a port):
  * Mesh = dense arrays (points, cells, ELL adjacency) built host-side once.
  * Assembly = closed-form per-cell local matrices, vmapped over cells,
    scatter-added into an ELL sparse layout via sorted segment_sum
    (replaces UFL/ffcx codegen, ref Code/Linear_advection/linear_advection.py:110-124).
  * Linear solves = matrix-free Krylov (CG / BiCGStab, Jacobi precond)
    (replaces PETSc KSP LU, ref linear_advection.py:128-131).
  * Newton = jax.jvp Jacobian action inside lax.while_loop
    (replaces dolfinx NewtonSolver, ref Code/KPP/KPP_NodeRV.py:139-163).
  * RV/SI epsilon = vectorized patch reductions over the ELL structure
    (replaces O(N) Python loops, ref Code/Utils/RV.py:56-90, SI.py:38-67).
  * Time loops = lax.scan; distribution = shard_map over a jax Mesh with
    halo accumulation via collectives (replaces MPI ghostUpdate,
    ref linear_advection.py:165-170).

Precision policy: all kernels are dtype-parameterized. Accuracy-gated runs
(convergence tests, reference-field comparison) use float64 (native on CPU);
GPU throughput runs default to float32. Nothing in this package flips global
JAX flags — tests/conftest.py enables x64 for the test suite.
"""

__version__ = "0.1.0"

from conservation_fem_tpu.ops.mesh import (  # noqa: F401
    Mesh,
    rectangle_mesh,
    disk_mesh,
    mesh_from_arrays,
    load_h5_mesh,
)
