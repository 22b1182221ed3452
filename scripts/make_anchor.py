"""Generate the committed f64 CPU accuracy anchors for bench.py.

Recipe (the same one that produced golden/kpp_rv_anchor_mesh{32,64,128}.npy):
f64, CPU, adaptive Newton + 1e-12 Krylov (KPPConfig defaults), structured
mesh (stencil backend via backend="auto"), dt CFL-matched to the bench f32
run (dt = 0.01 * min(1, 64/mesh)), one full T=1.0 trajectory; the end state
is stored as f32 (the gate is L2rel ~1e-2, f32 storage is exact enough by
5 orders).

Usage:  python scripts/make_anchor.py 256       # structured mesh(es)
        python scripts/make_anchor.py 256 512
        python scripts/make_anchor.py irr140    # irregular (jittered
            Delaunay, ops/mesh.irregular_mesh seed=1) — anchors for the
            blocked unstructured scaling bench (bench_blocked_scaling);
            dt CFL-matched to the bench config (see _IRR)
"""

import os
import sys
import time

if __name__ == "__main__":
    # anchors are CPU f64 by definition; pin the platform BEFORE any jax
    # op (bench_blocked_scaling and chip_smoke.py import irr_problem from
    # here and must stay on the GPU, so the pin is main-only)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from conservation_fem_tpu.models import kpp  # noqa: E402


# irregular-mesh bench configs (shared with scripts/bench_blocked_scaling):
# dt keeps dt/h_min <= ~0.64 on the jittered mesh; T bounds the run.
_IRR = {140: dict(dt=0.005, T=0.5), 224: dict(dt=0.0025, T=0.25),
        316: dict(dt=0.0018, T=0.18),
        # large-N rows for the 2D tiled blocked backend: ~100 steps
        # each at CFL-matched dt; anchors are f64 CPU gather-ELL runs
        448: dict(dt=0.00125, T=0.125), 640: dict(dt=0.0009, T=0.09)}


# fixed-iteration solver config of the f32 irregular-mesh runs
# (bench_blocked_scaling, chip_smoke.py), gated against the irr anchors
IRR_FIXED = dict(modified_newton=True, cg_iters=10, newton_iters=3,
                 newton_linear_iters=8)


def irr_problem(nx, dtype, dt=None, T=None, **kw):
    """KPP on the jittered-Delaunay mesh irr{nx}, RCM-ordered like the
    committed anchors. dt/T default to the _IRR table (required for an nx
    outside it)."""
    from conservation_fem_tpu.ops.mesh import (
        irregular_mesh, rcm_permutation, reorder_mesh,
    )

    m = irregular_mesh((-2, -2), (2, 2), nx=nx, seed=1)
    m = reorder_mesh(m, rcm_permutation(m))
    cfg = kpp.KPPConfig(dtype=dtype,
                        dt=_IRR[nx]["dt"] if dt is None else dt,
                        T=_IRR[nx]["T"] if T is None else T,
                        backend="ell", **kw)
    if kw.get("ell_matvec_backend") == "blocked2d":
        # tile the RCM-ordered mesh so u_slots[prob.slot_of_node] is in
        # the SAME numbering as the committed irr anchors
        from conservation_fem_tpu.ops.tiling import tile_mesh

        mt, slot = tile_mesh(m)
        prob = kpp.build(cfg, host_mesh=mt)
        prob.slot_of_node = slot
        return prob
    return kpp.build(cfg, host_mesh=m)


def euler_problem(prob, nx, dtype):
    """Shared bench/anchor Euler config (imported by bench_euler).

    Model defaults only: EulerConfig.CRV=None resolves to 4.0 for
    riemann2d (the value the four-shock interaction needs at nx >= 128 —
    see the EulerConfig.CRV comment for the measured analysis) and to
    the reference-prototype 1.0 for sod/uniform."""
    from conservation_fem_tpu.models import euler

    return euler.build(euler.EulerConfig(problem=prob, nx=nx, dtype=dtype))


ADV_REF_H5 = "/root/reference/Code/Linear_advection/Data/RV/RV_cell.h5"


def adv_problem(dtype, **kw):
    """The bench_advection workload: RV-node linear advection on the
    reference's stored gmsh disk mesh (1011 nodes), T=1.0."""
    from conservation_fem_tpu.models import linear_advection as la
    from conservation_fem_tpu.ops.mesh import load_h5_mesh

    host = load_h5_mesh(ADV_REF_H5, geometry="Mesh/mesh/geometry",
                        topology="Mesh/mesh/topology")
    cfg = la.AdvectionConfig(T=1.0, stabilization="rv_node", dtype=dtype,
                             **kw)
    return la.build(cfg, host_mesh=host), la


def main():
    tokens = sys.argv[1:] or ["256"]
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")
    for tok in tokens:
        if tok.startswith("euler_"):
            # "euler_sod:100" / "euler_2d:128" — f64 anchors for
            # scripts/bench_euler.py (explicit SSP-RK2; f32 tracks f64 at
            # ~5e-7 on CPU, so the stored-f32 anchor is exact enough)
            from conservation_fem_tpu.models import euler

            prob, nx = tok.split(":")
            prob = {"euler_sod": "sod", "euler_2d": "riemann2d"}[prob]
            nx = int(nx)
            p = euler_problem(prob, nx, "float64")
            print(f"{tok}: N={p.U0.shape[0]}, steps={p.num_steps}",
                  flush=True)
            t0 = time.perf_counter()
            U = np.asarray(euler.solve(p).U, dtype=np.float64)
            rho = U[:, 0]
            assert np.isfinite(U).all() and rho.min() > 0.0 and \
                rho.max() < 2.0, f"rho range {rho.min()}..{rho.max()}"
            path = os.path.join(out_dir, f"euler_{prob}_anchor_nx{nx}.npy")
            np.save(path, U.astype(np.float32))
            print(f"  saved {path} in {time.perf_counter()-t0:.0f}s; "
                  f"rho {rho.min():.4f}..{rho.max():.4f}", flush=True)
            continue
        if tok == "adv":
            # f64 adaptive-1e-12 gather anchor for bench_advection
            p, la = adv_problem("float64")
            print(f"adv: N={p.u0.shape[0]}, dt={p.dt}, "
                  f"steps={p.num_steps}", flush=True)
            t0 = time.perf_counter()
            u = np.asarray(la.solve(p).u, dtype=np.float64)
            # smooth-bump transport on the disk: stays in [-eps, 1+eps]
            assert np.isfinite(u).all() and -0.2 < u.min() and u.max() < 1.2
            path = os.path.join(out_dir, "adv_rvnode_anchor_refdisk.npy")
            np.save(path, u.astype(np.float32))
            print(f"  saved {path} in {time.perf_counter()-t0:.0f}s; "
                  f"range {u.min():.4f}..{u.max():.4f}", flush=True)
            continue
        if tok.startswith("irr"):
            nx = int(tok[3:])
            p = irr_problem(nx, "float64", krylov_rtol=1e-12)
            print(f"irr{nx}: N={p.u0.shape[0]}, dt={p.dt}, "
                  f"steps={p.num_steps}", flush=True)
            t0 = time.perf_counter()
            u = np.asarray(p.solve().u, dtype=np.float64)
            # wider sanity window than the structured anchors: RV permits
            # isolated shock-adjacent undershoots on irregular meshes
            # (measured: one node at 0.426 on irr224, f64 adaptive)
            assert np.isfinite(u).all() and 0.2 < u.min() and u.max() < 12.5
            path = os.path.join(out_dir, f"kpp_rv_anchor_irr{nx}.npy")
            np.save(path, u.astype(np.float32))
            print(f"  saved {path} in {time.perf_counter()-t0:.0f}s; "
                  f"range {u.min():.4f}..{u.max():.4f}", flush=True)
            continue
        # "512:T0.1" — SHORT-horizon anchor: a full T=1.0 f64 trajectory
        # at mesh 512 costs ~12 h CPU (mesh 256 took 90 min); an 80-step
        # horizon still exercises shock formation + RV and gates the f32
        # sweep point (bench.py falls back to `kpp_rv_anchor_mesh{N}_T{x}
        # .npy` with a matching short solve when no full anchor exists)
        T = 1.0
        suffix = ""
        if ":" in tok:
            tok, tpart = tok.split(":")
            assert tpart.startswith("T")
            T = float(tpart[1:])
            suffix = f"_T{tpart[1:]}"
        ms = int(tok)
        dt = 0.01 * min(1.0, 64.0 / ms)
        p = kpp.build(kpp.KPPConfig(mesh_size=ms, dtype="float64", dt=dt,
                                    T=T, krylov_rtol=1e-12))
        print(f"mesh {ms}{suffix}: N={p.u0.shape[0]}, dt={dt}, "
              f"steps={p.num_steps}", flush=True)
        t0 = time.perf_counter()
        res = p.solve()
        u = np.asarray(res.u, dtype=np.float64)
        el = time.perf_counter() - t0
        assert np.isfinite(u).all() and 0.5 < u.min() and u.max() < 12.0, \
            f"anchor sanity failed: range {u.min()}..{u.max()}"
        path = os.path.join(out_dir, f"kpp_rv_anchor_mesh{ms}{suffix}.npy")
        np.save(path, u.astype(np.float32))
        print(f"  saved {path} in {el:.0f}s; range {u.min():.4f}.."
              f"{u.max():.4f}", flush=True)


if __name__ == "__main__":
    main()
