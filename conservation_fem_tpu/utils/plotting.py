"""Plotting: field snapshots, convergence plots, mesh plots, GIF animation.

Matplotlib-based parity with the reference's pyvista tooling
(ref Code/Utils/PDE_plot.py — plot_pv warped-field screenshots :45-69,
plot_convergence with fitted slope annotation :71-96, plot_grid :99-110;
Code/Utils/PDE_realtime_plot.py — per-step dual-pane GIF writer).
Headless-safe (Agg backend); no pyvista/X dependency. matplotlib is
imported when a plot is made, not with this module.
"""

from __future__ import annotations

import os

import numpy as np


def _mpl():
    """(pyplot, tri) on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri

    return plt, mtri


def _triangulation(mesh):
    _, mtri = _mpl()
    if getattr(mesh, "periodic", False):
        # make_periodic meshes: seam cells index the fold's master nodes,
        # so triangulating points[cells] draws domain-spanning triangles.
        # Drop the seam cells from the PLOT (solver data is untouched).
        p = np.asarray(mesh.points)[np.asarray(mesh.cells)]      # (M,3,2)
        span = np.ptp(p, axis=1).max(axis=1)                     # (M,)
        keep = span < 2.0 * float(np.asarray(mesh.h_cell).max())
        return mtri.Triangulation(
            mesh.points[:, 0], mesh.points[:, 1], mesh.cells[keep]
        )
    return mtri.Triangulation(
        mesh.points[:, 0], mesh.points[:, 1], mesh.cells
    )


def plot_dg_field(mesh, d, title, filename, location, show_edges=False):
    """DG0 ``(M,)`` / DG1 ``(M,3)`` field snapshot (ref
    KPP_NodeRV_plot.py's DG carriers). Vertices are duplicated per cell
    so inter-cell discontinuities render as true jumps instead of being
    smeared by a shared-vertex Gouraud fill."""
    plt, mtri = _mpl()
    os.makedirs(location, exist_ok=True)
    d = np.asarray(d)
    p = np.asarray(mesh.points)[np.asarray(mesh.cells)]      # (M,3,2)
    M = p.shape[0]
    tri = mtri.Triangulation(p[..., 0].ravel(), p[..., 1].ravel(),
                             np.arange(3 * M).reshape(M, 3))
    fig, ax = plt.subplots(figsize=(7, 6))
    if d.ndim == 1:                # DG0: one color per cell
        tpc = ax.tripcolor(tri, facecolors=d, cmap="viridis")
    else:                          # DG1: linear within, jumps between
        tpc = ax.tripcolor(tri, d.ravel(), shading="gouraud",
                           cmap="viridis")
    if show_edges:
        ax.triplot(tri, lw=0.2, color="k", alpha=0.3)
    fig.colorbar(tpc, ax=ax)
    ax.set_title(title)
    ax.set_aspect("equal")
    path = os.path.join(location, filename + ".png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_field(mesh, u, title, filename, location, three_d=False, show_edges=False):
    """Scalar P1 field snapshot, 2D tripcolor or 3D trisurf
    (ref PDE_plot.plot_pv, PDE_plot.py:45-69)."""
    plt, _ = _mpl()
    os.makedirs(location, exist_ok=True)
    tri = _triangulation(mesh)
    u = np.asarray(u)
    if three_d:
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_trisurf(tri, u, cmap="viridis", linewidth=0.1)
        ax.set_title(title)
    else:
        fig, ax = plt.subplots(figsize=(7, 6))
        tpc = ax.tripcolor(tri, u, shading="gouraud", cmap="viridis")
        if show_edges:
            ax.triplot(tri, lw=0.2, color="k", alpha=0.3)
        fig.colorbar(tpc, ax=ax)
        ax.set_title(title)
        ax.set_aspect("equal")
    path = os.path.join(location, filename + ".png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_grid(mesh, filename, location, node_labels=False):
    """Mesh wireframe (ref PDE_plot.plot_grid :99-110; node labels as in
    tests/verification/patch_test.py:162-181)."""
    plt, _ = _mpl()
    os.makedirs(location, exist_ok=True)
    tri = _triangulation(mesh)
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.triplot(tri, lw=0.5, color="k")
    if node_labels:
        for i, (x, y) in enumerate(mesh.points):
            ax.annotate(str(i), (x, y), fontsize=7, color="red")
    ax.set_aspect("equal")
    path = os.path.join(location, filename + ".png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_convergence(errors, mesh_sizes, title, filename, location):
    """log-log convergence plot with fitted slope annotation
    (ref PDE_plot.plot_convergence, PDE_plot.py:71-96)."""
    plt, _ = _mpl()
    os.makedirs(location, exist_ok=True)
    hs = 1.0 / np.asarray(mesh_sizes, dtype=float)
    errors = np.asarray(errors, dtype=float)
    slope, intercept = np.polyfit(np.log10(hs), np.log10(errors), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.loglog(hs, errors, "o-", label="L2 error")
    ax.loglog(hs, 10 ** (intercept + slope * np.log10(hs)), "--",
              label=f"fit slope = {slope:.2f}")
    ax.set_xlabel("h")
    ax.set_ylabel("L2 error")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    path = os.path.join(location, filename + ".png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path, slope


class RealtimePlot:
    """Dual-pane (solution + epsilon) GIF writer
    (ref Code/Utils/PDE_realtime_plot.py:7-100)."""

    def __init__(self, mesh, location, filename="evolution.gif", fps=10):
        os.makedirs(location, exist_ok=True)
        self.mesh = mesh
        self.path = os.path.join(location, filename)
        self.fps = fps
        self.frames = []

    def add_frame(self, u, eps=None, t=None):
        plt, _ = _mpl()
        tri = _triangulation(self.mesh)
        ncols = 2 if eps is not None else 1
        fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 5))
        axes = np.atleast_1d(axes)
        tpc = axes[0].tripcolor(tri, np.asarray(u), shading="gouraud",
                                cmap="viridis")
        fig.colorbar(tpc, ax=axes[0])
        axes[0].set_title(f"u{'' if t is None else f' (t={t:.3f})'}")
        axes[0].set_aspect("equal")
        if eps is not None:
            tpc2 = axes[1].tripcolor(tri, np.asarray(eps), shading="gouraud",
                                     cmap="magma")
            fig.colorbar(tpc2, ax=axes[1])
            axes[1].set_title("epsilon")
            axes[1].set_aspect("equal")
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        self.frames.append(buf.reshape(h, w, 4)[..., :3].copy())
        plt.close(fig)

    def close(self):
        if not self.frames:
            return None
        try:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(
                self.path, save_all=True, append_images=imgs[1:],
                duration=int(1000 / self.fps), loop=0,
            )
        except ImportError:
            # fall back to per-frame PNGs
            plt, _ = _mpl()
            base, _ = os.path.splitext(self.path)
            for i, f in enumerate(self.frames):
                plt.imsave(f"{base}_{i:04d}.png", f)
        return self.path
