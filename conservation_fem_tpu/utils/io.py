"""XDMF/HDF5 time-series I/O, format-compatible with the reference's
DOLFINx output (ref Code/Linear_advection/linear_advection.py:96-97,176
writes Mesh/mesh/{geometry,topology} + Function/<name>/<time> datasets;
Data/*.h5 files in the reference follow this layout).

Reader side ingests the reference's stored golden data for parity tests;
writer side produces the same layout (HDF5 + ASCII XDMF index) so outputs
are ParaView-compatible and cross-readable with FEniCSx tooling.
"""

from __future__ import annotations

import os

import numpy as np

from conservation_fem_tpu.ops.mesh import Mesh, mesh_from_arrays


def _time_key(t: float) -> str:
    """DOLFINx encodes dataset names as repr(t) with '.' -> '_'."""
    return repr(float(t)).replace(".", "_")


def _key_time(k: str) -> float:
    return float(k.replace("_", "."))


def read_h5_mesh(path: str) -> Mesh:
    import h5py

    with h5py.File(path, "r") as f:
        return mesh_from_arrays(
            np.asarray(f["Mesh/mesh/geometry"])[:, :2],
            np.asarray(f["Mesh/mesh/topology"]),
        )


def read_h5_series(path: str, name: str):
    """Read Function/<name>/* -> (times (T,), values (T, ndof)) sorted."""
    import h5py

    with h5py.File(path, "r") as f:
        grp = f[f"Function/{name}"]
        keys = sorted(grp.keys(), key=_key_time)
        times = np.array([_key_time(k) for k in keys])
        vals = np.stack([np.asarray(grp[k])[:, 0] for k in keys])
    return times, vals


class XDMFWriter:
    """Minimal XDMF+HDF5 time-series writer (P1 scalar fields on triangles).

    Mirrors io.XDMFFile usage in the reference: write_mesh once, then
    write_function(u, t) per step (ref linear_advection.py:96-97,176).
    """

    def __init__(self, path: str, mesh: Mesh):
        import h5py

        base, _ = os.path.splitext(path)
        self.h5_path = base + ".h5"
        self.xdmf_path = base + ".xdmf"
        self.mesh = mesh
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._h5 = h5py.File(self.h5_path, "w")
        self._h5.create_dataset("Mesh/mesh/geometry", data=mesh.points)
        self._h5.create_dataset(
            "Mesh/mesh/topology", data=mesh.cells.astype(np.int64)
        )
        self._entries: list[tuple[str, float, str]] = []

    def write_function(self, u, t: float, name: str = "uh"):
        key = _time_key(t)
        self._h5.create_dataset(
            f"Function/{name}/{key}", data=np.asarray(u).reshape(-1, 1)
        )
        self._entries.append((name, float(t), key))

    def close(self):
        self._h5.close()
        n, m = self.mesh.n_nodes, self.mesh.n_cells
        h5 = os.path.basename(self.h5_path)
        grids = []
        for name, t, key in self._entries:
            grids.append(f"""      <Grid Name="{name}_{key}" GridType="Uniform">
        <Topology TopologyType="Triangle" NumberOfElements="{m}">
          <DataItem Dimensions="{m} 3" NumberType="Int" Format="HDF">{h5}:/Mesh/mesh/topology</DataItem>
        </Topology>
        <Geometry GeometryType="XY">
          <DataItem Dimensions="{n} 2" Format="HDF">{h5}:/Mesh/mesh/geometry</DataItem>
        </Geometry>
        <Time Value="{t}" />
        <Attribute Name="{name}" AttributeType="Scalar" Center="Node">
          <DataItem Dimensions="{n} 1" Format="HDF">{h5}:/Function/{name}/{key}</DataItem>
        </Attribute>
      </Grid>""")
        body = "\n".join(grids)
        with open(self.xdmf_path, "w") as f:
            f.write(f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="TimeSeries" GridType="Collection" CollectionType="Temporal">
{body}
    </Grid>
  </Domain>
</Xdmf>
""")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VTXWriter:
    """Time-series field writer with the DOLFINx VTXWriter surface
    (ref Code/Compressible_euler/stokes.py:130-133,182-183,192-193:
    ``VTXWriter(comm, path, func, engine="BP4")`` + ``write(t)`` +
    ``close()``).

    DOCUMENTED SUBSTITUTION: the reference engine is ADIOS2 BP4; adios2
    is not available in this environment (and is a heavyweight C++
    dependency with no device role), so this writes the ParaView-native
    equivalent — one binary-appended ``.vtu`` per time step plus a
    ``.pvd`` index — which serves the identical purpose (time-series
    visualization of P1 scalar/vector fields in ParaView). A ``*.bp``
    path is honoured as a DIRECTORY of that name containing the series,
    so reference-shaped call sites keep their paths verbatim.

    Per-write I/O cost is measured (``stats`` -> bytes + seconds), making
    the BASELINE.md I/O row (reference VTX: ~18.6 MB, ~17.1 ms/write)
    directly comparable (tests/test_vtx.py).

    Fields are bound at construction like DOLFINx Functions: pass either
    an array (snapshotted at each ``write`` from whatever you reassign
    ``self.field`` to) or a zero-arg callable returning the current
    nodal values — scalar ``(N,)`` or vector ``(N, d)``.
    """

    def __init__(self, path, mesh: Mesh, field, name: str = "u",
                 engine: str = "BP4"):
        del engine  # API compatibility; single implementation
        self.dir = str(path)
        if not self.dir.endswith(".bp"):
            self.dir += ".bp"
        os.makedirs(self.dir, exist_ok=True)
        self.mesh = mesh
        self.field = field
        self.name = name
        self._steps: list[tuple[float, str]] = []
        self.bytes_written = 0
        self.write_seconds = 0.0

    # -- vtu encoding ------------------------------------------------------

    def _snapshot(self) -> np.ndarray:
        u = self.field() if callable(self.field) else self.field
        u = np.asarray(u, dtype=np.float64)
        if u.ndim == 1:
            u = u[:, None]
        return u

    def _vtu_bytes(self, u: np.ndarray) -> bytes:
        m = self.mesh
        pts = np.zeros((m.n_nodes, 3))
        pts[:, :2] = np.asarray(m.points)
        cells = np.asarray(m.cells, dtype=np.int64)
        ncomp = u.shape[1]
        if ncomp == 2:  # ParaView vectors are 3-component
            u = np.pad(u, ((0, 0), (0, 1)))
            ncomp = 3
        blocks = [
            pts.astype("<f8").tobytes(),
            cells.astype("<i8").tobytes(),
            (3 * np.arange(1, m.n_cells + 1, dtype="<i8")).tobytes(),
            np.full(m.n_cells, 5, dtype="u1").tobytes(),  # VTK_TRIANGLE
            np.ascontiguousarray(u.astype("<f8")).tobytes(),
        ]
        offs = np.cumsum([0] + [8 + len(b) for b in blocks[:-1]])
        darr = (
            '<DataArray type="{ty}" Name="{nm}"{nc} format="appended" '
            'offset="{off}"/>'
        )
        head = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian" header_type="UInt64">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{m.n_nodes}" NumberOfCells="{m.n_cells}">
      <Points>
        {darr.format(ty="Float64", nm="Points", nc=' NumberOfComponents="3"', off=offs[0])}
      </Points>
      <Cells>
        {darr.format(ty="Int64", nm="connectivity", nc="", off=offs[1])}
        {darr.format(ty="Int64", nm="offsets", nc="", off=offs[2])}
        {darr.format(ty="UInt8", nm="types", nc="", off=offs[3])}
      </Cells>
      <PointData>
        {darr.format(ty="Float64", nm=self.name, nc=f' NumberOfComponents="{ncomp}"' if ncomp > 1 else "", off=offs[4])}
      </PointData>
    </Piece>
  </UnstructuredGrid>
  <AppendedData encoding="raw">
   _"""
        tail = b"\n  </AppendedData>\n</VTKFile>\n"
        payload = b"".join(
            np.uint64(len(b)).tobytes() + b for b in blocks)
        return head.encode() + payload + tail

    # -- public API --------------------------------------------------------

    def write(self, t: float, field=None):
        import time as _t

        if field is not None:
            self.field = field
        t0 = _t.perf_counter()
        data = self._vtu_bytes(self._snapshot())
        fname = f"step_{len(self._steps):06d}.vtu"
        with open(os.path.join(self.dir, fname), "wb") as f:
            f.write(data)
        self.write_seconds += _t.perf_counter() - t0
        self.bytes_written += len(data)
        self._steps.append((float(t), fname))

    def close(self):
        lines = "\n".join(
            f'    <DataSet timestep="{t}" file="{f}"/>'
            for t, f in self._steps)
        with open(os.path.join(self.dir, "series.pvd"), "w") as f:
            f.write(f"""<?xml version="1.0"?>
<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">
  <Collection>
{lines}
  </Collection>
</VTKFile>
""")

    @property
    def stats(self):
        n = max(1, len(self._steps))
        return {"writes": len(self._steps),
                "bytes_total": self.bytes_written,
                "bytes_per_write": self.bytes_written // n,
                "seconds_total": self.write_seconds,
                "ms_per_write": 1e3 * self.write_seconds / n}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
