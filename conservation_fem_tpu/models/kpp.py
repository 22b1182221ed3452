"""KPP rotating-wave benchmark: u_t + div(sin u, cos u) = 0.

The rebuild's north-star workload (BASELINE.json). Reference:
Code/KPP/KPP_NodeRV.py — domain [-2,2]^2 at hmax=1/32 (gmsh rectangle,
:32-41), IC = 14*pi/4 inside the unit circle else pi/4 (:50-51),
Dirichlet bc = pi/4 (:86), dt = 0.01, T = 1 (:70-74), Cvel = 0.5,
CRV = 4.0 (:75-76); quasilinear flux derivative f'(u) = (cos u, -sin u)
(:53-55) so |f'(u)| = 1 identically. Variants: SI (Cm=0.5,
ref KPP_SI.py:72), GFEM (no stabilization, ref KPP.py — demonstrates the
wrong rotating wave), exact-field generator at hmax=1/64
(ref KPP_exact.py:38).

The mesh is either a deterministic structured triangulation of [-2,2]^2
(default) or the stored reference gmsh mesh Data/KPP_RV.h5 (for field
comparison against the FEniCSx reference).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from conservation_fem_tpu.models.scalar_hyperbolic import (
    HyperbolicConfig,
    HyperbolicProblem,
)
from conservation_fem_tpu.ops.mesh import Mesh, load_h5_mesh, rectangle_mesh

KPP_REFERENCE_H5 = "/root/reference/Data/KPP_RV.h5"


@dataclasses.dataclass(frozen=True)
class KPPConfig:
    mesh_size: int = 32            # cells per unit length: hmax = 1/mesh_size
    mesh_source: str = "structured"  # "structured" | path to .h5
    stabilization: str = "rv"      # rv | si | gfem
    dt: float = 0.01               # ref KPP_NodeRV.py:73
    T: float = 1.0
    Cvel: float = 0.5              # ref KPP_NodeRV.py:75
    CRV: float = 4.0               # ref KPP_NodeRV.py:76
    Cm: float = 0.5                # ref KPP_SI.py:72
    smooth_l: float = 0.0          # >0: post-solve patch smoothing
    newton_rtol: float = 1e-4
    newton_atol: float = 1e-10
    krylov_rtol: float = 1e-12
    newton_linear_rtol: float | None = None
    modified_newton: bool = False
    # fixed-iteration unrolled solvers (see HyperbolicConfig): throughput
    # paths set these; accuracy-gated runs keep the adaptive (None) solvers
    cg_iters: int | None = None
    newton_iters: int | None = None
    newton_linear_iters: int = 8
    inner_solver: str = "bicgstab"  # "cheby": dot-free inner solves
    newton_final_residual: bool = True  # see HyperbolicConfig
    precise_reductions: bool = False    # see HyperbolicConfig
    solver_unroll: bool = True          # see HyperbolicConfig
    # lean structured mesh (ops/mesh.rectangle_mesh_lean): skip the
    # generic patch/scatter structure the stencil backend never reads —
    # its host build is O(N log N) in memory and passes 100 GB RAM at
    # mesh 2048. None = auto: lean whenever the stencil path will be used
    # and mesh_size >= 512. Identical geometry/trajectories (tested).
    lean_mesh: bool | None = None
    xla_bf16_planes: bool = False       # see HyperbolicConfig
    # unstructured operator application (h5/gmsh meshes): "gather" (XLA
    # gather ELL), "banded" (RCM diagonals), or "blocked" (blocked-window
    # dense contractions + RCM, ops/blocked.py).
    # banded/blocked meshes built here are RCM-reordered automatically;
    # caller-provided host_mesh must already be RCM-ordered.
    ell_matvec_backend: str = "gather"
    # blocked backend: matrix-free per-step operators (see HyperbolicConfig)
    blocked_matrix_free: bool = False
    dtype: str = "float64"
    record_metrics: bool = False
    # "auto": stencil backend on structured meshes (gather-free), ELL
    # otherwise. "ell" forces the generic path.
    backend: str = "auto"


def initial_condition(x, y):
    """14*pi/4 inside the unit circle, pi/4 outside (ref KPP_NodeRV.py:50-51)."""
    inside = (x**2 + y**2) <= 1.0
    return jnp.where(inside, 14.0 * jnp.pi / 4.0, jnp.pi / 4.0)


def flux_prime(u):
    """f(u) = (sin u, cos u) => f'(u) = (cos u, -sin u) (ref :53-55)."""
    return jnp.stack([jnp.cos(u), -jnp.sin(u)], axis=-1)


def flux_prime_norm(u):
    return jnp.ones_like(u)


# componentwise form of flux_prime: the plane-form quadrature kernels
# (ops/structured.nonlinear_rhs / flux_jacobian_coef) evaluate each
# component as its own grid-shaped array instead of a stacked (...,2) one
flux_prime_xy = (jnp.cos, lambda u: -jnp.sin(u))


def build(cfg: KPPConfig | None = None, host_mesh: Mesh | None = None, **kw):
    if cfg is None:
        cfg = KPPConfig(**kw)
    built_structured = host_mesh is None and cfg.mesh_source == "structured"
    will_stencil = (
        built_structured
        and cfg.backend in ("auto", "stencil")
        and cfg.stabilization in ("rv", "si", "gfem")
        and cfg.ell_matvec_backend == "gather"
    )
    lean = (cfg.lean_mesh if cfg.lean_mesh is not None
            else will_stencil and cfg.mesh_size >= 512)
    if host_mesh is None:
        if cfg.mesh_source == "structured":
            n = 4 * cfg.mesh_size   # [-2,2] spans 4 units
            if lean:
                from conservation_fem_tpu.ops.mesh import rectangle_mesh_lean

                host_mesh = rectangle_mesh_lean((-2, -2), (2, 2), nx=n,
                                                ny=n)
            else:
                host_mesh = rectangle_mesh((-2, -2), (2, 2), nx=n, ny=n)
        else:
            host_mesh = load_h5_mesh(cfg.mesh_source)
        if cfg.ell_matvec_backend in ("banded", "blocked"):
            from conservation_fem_tpu.ops.mesh import (
                rcm_permutation, reorder_mesh,
            )

            host_mesh = reorder_mesh(host_mesh, rcm_permutation(host_mesh))
        elif cfg.ell_matvec_backend == "blocked2d":
            from conservation_fem_tpu.ops.tiling import tile_mesh

            host_mesh, slot_of_node = tile_mesh(host_mesh)
    hcfg = HyperbolicConfig(
        stabilization=cfg.stabilization,
        Cvel=cfg.Cvel, CRV=cfg.CRV, Cm=cfg.Cm,
        newton_rtol=cfg.newton_rtol, newton_atol=cfg.newton_atol,
        krylov_rtol=cfg.krylov_rtol, newton_linear_rtol=cfg.newton_linear_rtol,
        modified_newton=cfg.modified_newton, smooth_l=cfg.smooth_l,
        cg_iters=cfg.cg_iters, newton_iters=cfg.newton_iters,
        newton_linear_iters=cfg.newton_linear_iters,
        inner_solver=cfg.inner_solver,
        newton_final_residual=cfg.newton_final_residual,
        precise_reductions=cfg.precise_reductions,
        solver_unroll=cfg.solver_unroll,
        xla_bf16_planes=cfg.xla_bf16_planes,
        ell_matvec_backend=cfg.ell_matvec_backend,
        blocked_matrix_free=cfg.blocked_matrix_free,
        dtype=cfg.dtype, record_metrics=cfg.record_metrics,
    )
    if cfg.ell_matvec_backend in ("blocked", "blocked2d"):
        from conservation_fem_tpu.models.blocked_hyperbolic import (
            BlockedHyperbolicProblem,
        )

        problem_cls = BlockedHyperbolicProblem
    else:
        problem_cls = HyperbolicProblem
    bc_val = float(np.pi / 4.0)
    prob = problem_cls(
        hcfg, host_mesh,
        flux_prime=flux_prime,
        flux_prime_norm=flux_prime_norm,
        bc_value=lambda pts, t: jnp.full(pts.shape[0], bc_val, pts.dtype),
        u0_fn=initial_condition,
        dt=cfg.dt,
        num_steps=int(np.ceil(cfg.T / cfg.dt)),
    )
    prob.flux_prime_xy = flux_prime_xy
    prob.bc_static = True          # g = pi/4 for all t (ref KPP_NodeRV.py)
    if cfg.ell_matvec_backend == "blocked2d" and "slot_of_node" in dir():
        # solutions live in the padded tile-slot numbering:
        # u_native = u_slots[prob.slot_of_node]. (A caller-provided
        # host_mesh must already be a tiling.tile_mesh mesh; the caller
        # then owns the slot map.)
        prob.slot_of_node = slot_of_node
    use_stencil = (
        cfg.backend in ("auto", "stencil")
        and built_structured
        and cfg.stabilization in ("rv", "si", "gfem")
    )
    if cfg.backend == "ell":
        use_stencil = False
    if use_stencil:
        from conservation_fem_tpu.models.structured_hyperbolic import structure

        n = 4 * cfg.mesh_size
        prob = structure(prob, n, n)
    return prob


def run(cfg: KPPConfig | None = None, **kw):
    return build(cfg, **kw).solve()


def generate_reference(path: str, mesh_size: int = 64, **kw):
    """Generate a fine-mesh reference field, parity with
    Code/KPP/KPP_exact.py (hmax=1/64, dt=0.01, T=1, :38,75-78): runs the
    node-RV solver and writes the mesh + final field as XDMF/HDF5."""
    from conservation_fem_tpu.utils.io import XDMFWriter

    p = build(KPPConfig(mesh_size=mesh_size, **kw))
    res = p.solve()
    with XDMFWriter(path, p.host_mesh) as w:
        w.write_function(res.u, p.num_steps * p.dt, name="uh")
    return res


def compare_to_reference(path: str, u, host_mesh, name="uh"):
    """L2 distance to a stored reference field on the same mesh — the
    comparison KPP_conv.py:30-33 stubs out."""
    import jax.numpy as jnp

    from conservation_fem_tpu.ops import assembly
    from conservation_fem_tpu.ops.spmv import ell_matvec
    from conservation_fem_tpu.utils.io import read_h5_series

    _, vals = read_h5_series(path.replace(".xdmf", ".h5"), name)
    m = host_mesh.device_arrays(jnp.asarray(u).dtype)
    M = assembly.assemble_mass(m)
    d = jnp.asarray(u) - jnp.asarray(vals[-1])
    return float(jnp.sqrt(d @ ell_matvec(m, M, d)))
