"""Tutorial: the conservation-fem-tpu API end to end.

Covers, in ~80 lines: meshing, assembly, a boundary-value solve, a
stabilized time-dependent solve with metrics, checkpoint/resume, error
measurement, plotting, and I/O. Run on CPU:

    python examples/tutorial.py
"""

import jax

jax.config.update("jax_platforms", "cpu")      # the tutorial runs on the CPU
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def main():
    # ---- 1. meshes are arrays --------------------------------------------
    from conservation_fem_tpu.ops.mesh import disk_mesh, rectangle_mesh

    mesh = disk_mesh(hmax=1 / 16)              # deterministic unit disk
    print(f"mesh: {mesh.n_nodes} nodes, {mesh.n_cells} cells, "
          f"{int(mesh.boundary_mask.sum())} boundary nodes")
    m = mesh.device_arrays(jnp.float64)        # jax bundle for kernels

    # ---- 2. assembly + a Poisson solve ------------------------------------
    from conservation_fem_tpu.ops import assembly
    from conservation_fem_tpu.ops.bc import constrained_operator, lift_rhs
    from conservation_fem_tpu.ops.krylov import cg

    K = assembly.assemble_stiffness(m)         # ELL sparse (N, K_patch)
    g = m.points[:, 0] ** 2 - m.points[:, 1] ** 2   # harmonic boundary data
    b = lift_rhs(m, K, jnp.zeros(mesh.n_nodes), g, m.boundary_mask)
    sol = cg(constrained_operator(m, K, m.boundary_mask), b, rtol=1e-12)
    err = assembly.l2_error_vs_function(m, sol.x, lambda x, y: x * x - y * y)
    print(f"Poisson: CG iters={int(sol.iters)}, L2 error vs exact "
          f"{float(err):.2e} (O(h^2) discretization)")

    # ---- 3. a stabilized conservation-law run -----------------------------
    from conservation_fem_tpu.models import kpp

    cfg = kpp.KPPConfig(mesh_size=8, record_metrics=True)
    problem = kpp.build(cfg)                   # auto-selects stencil backend
    result = problem.solve()
    mets = result.metrics
    print(f"KPP RV: {result.num_steps} steps, Newton converged every step: "
          f"{bool(mets['newton_converged'].all())}, "
          f"u in [{float(result.u.min()):.2f}, {float(result.u.max()):.2f}]")

    # ---- 4. checkpoint / resume -------------------------------------------
    import tempfile, os

    ck = os.path.join(tempfile.mkdtemp(), "kpp.npz")
    r1 = kpp.build(cfg).solve(checkpoint_path=ck, checkpoint_every=25)
    r2 = kpp.build(cfg).solve(checkpoint_path=ck, checkpoint_every=25,
                              resume=True)    # instant: resumes at the end
    assert np.array_equal(np.asarray(r1.u), np.asarray(r2.u))
    print("checkpoint/resume: bit-exact")

    # ---- 5. plots + I/O ----------------------------------------------------
    from conservation_fem_tpu.utils import plotting
    from conservation_fem_tpu.utils.io import XDMFWriter, read_h5_series

    out = tempfile.mkdtemp()
    plotting.plot_field(problem.host_mesh, result.u, "KPP RV", "kpp", out)
    with XDMFWriter(os.path.join(out, "kpp.xdmf"), problem.host_mesh) as w:
        w.write_function(result.u, result.num_steps * result.dt)
    times, vals = read_h5_series(os.path.join(out, "kpp.h5"), "uh")
    print(f"wrote + re-read XDMF series: {len(times)} snapshot(s) -> {out}")

    # ---- 6. multi-chip (works on any device count, incl. 1) ---------------
    from conservation_fem_tpu.parallel.structured_sharded import shard_structured

    devs = jax.devices()
    dmesh = jax.sharding.Mesh(np.array(devs), ("i",))
    u_sh = shard_structured(kpp.build(cfg), dmesh).solve()
    print(f"sharded solve on {len(devs)} device(s): max |diff| vs single = "
          f"{float(jnp.abs(jnp.asarray(u_sh) - result.u).max()):.2e}")


if __name__ == "__main__":
    main()
