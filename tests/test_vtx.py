"""VTXWriter substitution tests (ref Code/Compressible_euler/stokes.py:
130-133,182-183,192-193 — VTXWriter(comm, path, func, engine="BP4") +
write(t)/close()).

The reference engine is ADIOS2 BP4 (not available here, and a pure C++
I/O dependency with no device role); utils/io.VTXWriter writes the
ParaView-native equivalent — one binary-appended .vtu per step + a .pvd
index inside the reference-shaped ``*.bp`` directory — and measures its
own I/O cost for comparison with the reference's profile
(BASELINE.md: 18,635,779 bytes, ≈17.1 ms/write, poiseuille_u.bp).
Unlike BP4 (mesh written once), each .vtu is self-contained (mesh
re-written per step); the mesh-once time-series format remains
utils/io.XDMFWriter.
"""

import os
import struct

import numpy as np
import pytest

from conservation_fem_tpu.ops.mesh import rectangle_mesh
from conservation_fem_tpu.utils.io import VTXWriter


def _read_appended(path):
    """Parse the raw appended blocks of a .vtu written by VTXWriter."""
    raw = open(path, "rb").read()
    j = raw.index(b'encoding="raw">')
    j = raw.index(b"_", j) + 1
    blocks = []
    for _ in range(5):
        n = struct.unpack("<Q", raw[j:j + 8])[0]
        blocks.append(raw[j + 8:j + 8 + n])
        j += 8 + n
    return blocks


@pytest.fixture(scope="module")
def mesh():
    return rectangle_mesh((0.0, 0.0), (1.0, 1.0), 8, 8)


def test_vtu_roundtrip_scalar(tmp_path, mesh):
    u = np.linspace(0.0, 1.0, mesh.n_nodes)
    w = VTXWriter(tmp_path / "u.bp", mesh, u, name="uh")
    w.write(0.0)
    w.write(0.5, field=2.0 * u)
    w.close()
    d = str(tmp_path / "u.bp")
    assert sorted(os.listdir(d)) == [
        "series.pvd", "step_000000.vtu", "step_000001.vtu"]
    pts, conn, offs, types, vals = _read_appended(
        os.path.join(d, "step_000001.vtu"))
    pts = np.frombuffer(pts, "<f8").reshape(-1, 3)
    assert np.allclose(pts[:, :2], np.asarray(mesh.points))
    assert pts[:, 2].max() == 0.0
    conn = np.frombuffer(conn, "<i8").reshape(-1, 3)
    assert np.array_equal(conn, np.asarray(mesh.cells))
    assert np.frombuffer(types, "u1").tolist() == [5] * mesh.n_cells
    assert np.allclose(np.frombuffer(vals, "<f8"), 2.0 * u)
    pvd = open(os.path.join(d, "series.pvd")).read()
    assert 'timestep="0.0"' in pvd and 'timestep="0.5"' in pvd
    assert pvd.count("<DataSet") == 2


def test_vtu_vector_padded_to_3(tmp_path, mesh):
    vel = np.stack([np.arange(mesh.n_nodes, dtype=float),
                    -np.arange(mesh.n_nodes, dtype=float)], axis=1)
    w = VTXWriter(tmp_path / "vel", mesh, lambda: vel, name="vel")
    w.write(0.0)
    w.close()
    # .bp suffix is appended for reference-shaped directory naming
    d = str(tmp_path / "vel.bp")
    vals = np.frombuffer(_read_appended(
        os.path.join(d, "step_000000.vtu"))[4], "<f8").reshape(-1, 3)
    assert np.allclose(vals[:, :2], vel)
    assert vals[:, 2].max() == 0.0
    assert b'NumberOfComponents="3"' in open(
        os.path.join(d, "step_000000.vtu"), "rb").read(2000)


def test_io_stats_measured(tmp_path, mesh):
    u = np.zeros(mesh.n_nodes)
    w = VTXWriter(tmp_path / "s.bp", mesh, u)
    for k in range(3):
        w.write(0.1 * k)
    w.close()
    s = w.stats
    assert s["writes"] == 3
    assert s["bytes_total"] == 3 * s["bytes_per_write"] > 0
    assert s["seconds_total"] > 0.0
    # every byte accounted on disk
    d = str(tmp_path / "s.bp")
    on_disk = sum(os.path.getsize(os.path.join(d, f))
                  for f in os.listdir(d) if f.endswith(".vtu"))
    assert on_disk == s["bytes_total"]
