// Native mesh preprocessor for conservation_fem_tpu.
//
// Role: the compiled host-side component of the framework — the analog of
// the reference's native layer (Burger_CPP/: compiled element kernels +
// driver; SURVEY.md section 2.6 native-parity requirement). On the device
// the element kernels live in XLA; what remains genuinely host-side and
// irregular is mesh preprocessing:
//
//   * node-adjacency (patch) graph construction from the cell list
//     (the structure behind SI.get_patch_dictionary, ref SI.py:12-28),
//   * boundary-edge detection,
//   * reverse Cuthill-McKee (RCM) node reordering for gather locality in
//     the ELL SpMV hot loop (SURVEY.md section 7 "hard parts" #2).
//
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).
// The Python fallback (ops/mesh.py) computes identical results in NumPy;
// this path wins on large meshes where graph construction is
// sort/hash-bound.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Build the node-adjacency CSR (including self-loops), boundary mask and
// RCM permutation for a triangle mesh.
//
// cells:        n_cells x 3 int32
// boundary_out: n_nodes uint8 (1 = boundary node)
// rowptr_out:   n_nodes + 1 int64
// cols_out:     capacity >= unique pairs; filled with sorted neighbor ids
// nnz_out:      actual number of stored (row, col) pairs
// rcm_out:      n_nodes int32 — permutation: new_id = rcm_out[old_id]
//
// Returns 0 on success, -1 if cols_capacity is too small.
int cft_preprocess_mesh(
    int64_t n_nodes, int64_t n_cells, const int32_t* cells,
    uint8_t* boundary_out,
    int64_t* rowptr_out, int32_t* cols_out, int64_t cols_capacity,
    int64_t* nnz_out,
    int32_t* rcm_out) {
  // ---- adjacency pairs (all ordered pairs within each cell, incl. self)
  std::vector<int64_t> pairs;
  pairs.reserve(static_cast<size_t>(n_cells) * 9);
  for (int64_t c = 0; c < n_cells; ++c) {
    const int32_t* v = cells + 3 * c;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        pairs.push_back((static_cast<int64_t>(v[a]) << 32) |
                        static_cast<uint32_t>(v[b]));
  }
  std::sort(pairs.begin(), pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  const int64_t nnz = static_cast<int64_t>(pairs.size());
  *nnz_out = nnz;
  if (nnz > cols_capacity) return -1;

  std::fill(rowptr_out, rowptr_out + n_nodes + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t row = pairs[k] >> 32;
    rowptr_out[row + 1]++;
  }
  for (int64_t i = 0; i < n_nodes; ++i) rowptr_out[i + 1] += rowptr_out[i];
  for (int64_t k = 0; k < nnz; ++k)
    cols_out[k] = static_cast<int32_t>(pairs[k] & 0xffffffff);

  // ---- boundary edges: edges seen by exactly one cell
  std::vector<int64_t> edges;
  edges.reserve(static_cast<size_t>(n_cells) * 3);
  const int ea[3] = {0, 1, 2}, eb[3] = {1, 2, 0};
  for (int64_t c = 0; c < n_cells; ++c) {
    const int32_t* v = cells + 3 * c;
    for (int e = 0; e < 3; ++e) {
      int64_t a = v[ea[e]], b = v[eb[e]];
      if (a > b) std::swap(a, b);
      edges.push_back((a << 32) | static_cast<uint32_t>(b));
    }
  }
  std::sort(edges.begin(), edges.end());
  std::memset(boundary_out, 0, n_nodes);
  for (size_t k = 0; k < edges.size();) {
    size_t j = k;
    while (j < edges.size() && edges[j] == edges[k]) ++j;
    if (j - k == 1) {
      boundary_out[edges[k] >> 32] = 1;
      boundary_out[edges[k] & 0xffffffff] = 1;
    }
    k = j;
  }

  // ---- reverse Cuthill-McKee over the (self-loop-free) adjacency
  std::vector<int32_t> degree(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i)
    degree[i] = static_cast<int32_t>(rowptr_out[i + 1] - rowptr_out[i]) - 1;
  std::vector<int32_t> order;
  order.reserve(n_nodes);
  std::vector<uint8_t> visited(n_nodes, 0);
  std::vector<int32_t> nbrs;
  for (;;) {
    // next start: unvisited node of minimum degree
    int64_t start = -1;
    int32_t best = INT32_MAX;
    for (int64_t i = 0; i < n_nodes; ++i)
      if (!visited[i] && degree[i] < best) { best = degree[i]; start = i; }
    if (start < 0) break;
    std::queue<int32_t> q;
    q.push(static_cast<int32_t>(start));
    visited[start] = 1;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t k = rowptr_out[u]; k < rowptr_out[u + 1]; ++k) {
        int32_t w = cols_out[k];
        if (w != u && !visited[w]) { visited[w] = 1; nbrs.push_back(w); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t x, int32_t y) { return degree[x] < degree[y]; });
      for (int32_t w : nbrs) q.push(w);
    }
  }
  // reverse; rcm_out maps old -> new
  for (int64_t i = 0; i < n_nodes; ++i)
    rcm_out[order[n_nodes - 1 - i]] = static_cast<int32_t>(i);
  return 0;
}

// Structured rectangle triangulation (right diagonal), matching
// ops/mesh.rectangle_mesh: fills points (n_pts x 2) and cells (n_cells x 3).
void cft_structured_rectangle(
    int64_t nx, int64_t ny, double x0, double y0, double x1, double y1,
    double* points_out, int32_t* cells_out) {
  const double dx = (x1 - x0) / nx, dy = (y1 - y0) / ny;
  for (int64_t i = 0; i <= nx; ++i)
    for (int64_t j = 0; j <= ny; ++j) {
      int64_t id = i * (ny + 1) + j;
      points_out[2 * id] = x0 + i * dx;
      points_out[2 * id + 1] = y0 + j * dy;
    }
  int64_t c = 0;
  // first all lower triangles, then all upper (matches the NumPy builder's
  // concatenation order)
  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j) {
      int32_t v00 = static_cast<int32_t>(i * (ny + 1) + j);
      int32_t v10 = static_cast<int32_t>((i + 1) * (ny + 1) + j);
      int32_t v11 = v10 + 1;
      cells_out[3 * c] = v00; cells_out[3 * c + 1] = v10;
      cells_out[3 * c + 2] = v11;
      ++c;
    }
  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j) {
      int32_t v00 = static_cast<int32_t>(i * (ny + 1) + j);
      int32_t v11 = static_cast<int32_t>((i + 1) * (ny + 1) + j + 1);
      int32_t v01 = v00 + 1;
      cells_out[3 * c] = v00; cells_out[3 * c + 1] = v11;
      cells_out[3 * c + 2] = v01;
      ++c;
    }
}

}  // extern "C"
