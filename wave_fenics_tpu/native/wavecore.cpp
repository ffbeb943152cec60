// wavecore: native host-precompute kernels for wave_fenics_tpu.
//
// Equivalent of the reference's C++ host layer: the per-cell
// geometry precompute loops (common/precomputation.hpp:69-101,
// common/precompute.hpp:49-176) and the dof-identification machinery that
// DOLFINx provides to the reference (dofmap construction). The JAX/NumPy
// paths remain as the portable fallback; this library accelerates setup for
// large unstructured meshes (the device compute path stays XLA).
//
// Exposed as a plain C ABI (loaded via ctypes; no Python.h dependency).
// Build: see build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Geometry factors: J, |detJ|*w, G = J^-1 J^-T |detJ| w for trilinear hexes.
// cell_coords: [ncells, 8, 3] (basix vertex order)
// dphi:        [3, nq, 8] coordinate-basis gradients at quadrature points
// weights:     [nq]
// out_G:       [ncells, nq, 9]
// out_detJw:   [ncells, nq]
// Returns 0 on success, 1 if a singular Jacobian was found.
// ---------------------------------------------------------------------------
int geometry_factors(const double* cell_coords, const double* dphi,
                     const double* weights, int64_t ncells, int64_t nq,
                     double* out_G, double* out_detJw) {
  int bad = 0;
#pragma omp parallel for reduction(| : bad) schedule(static)
  for (int64_t c = 0; c < ncells; ++c) {
    const double* X = cell_coords + c * 8 * 3;
    for (int64_t q = 0; q < nq; ++q) {
      double J[3][3] = {{0}};
      for (int n = 0; n < 8; ++n) {
        const double x0 = X[n * 3 + 0], x1 = X[n * 3 + 1], x2 = X[n * 3 + 2];
        for (int j = 0; j < 3; ++j) {
          const double d = dphi[(j * nq + q) * 8 + n];
          J[0][j] += x0 * d;
          J[1][j] += x1 * d;
          J[2][j] += x2 * d;
        }
      }
      const double det = J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
                         J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
                         J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
      if (det == 0.0) {
        bad = 1;
        continue;
      }
      const double inv = 1.0 / det;
      double K[3][3];  // J^-1 (adjugate / det)
      K[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) * inv;
      K[0][1] = (J[0][2] * J[2][1] - J[0][1] * J[2][2]) * inv;
      K[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv;
      K[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * inv;
      K[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv;
      K[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * inv;
      K[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * inv;
      K[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * inv;
      K[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv;
      const double dw = std::fabs(det) * weights[q];
      out_detJw[c * nq + q] = dw;
      double* G = out_G + (c * nq + q) * 9;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          G[i * 3 + j] = dw * (K[i][0] * K[j][0] + K[i][1] * K[j][1] +
                               K[i][2] * K[j][2]);
        }
    }
  }
  return bad;
}

// ---------------------------------------------------------------------------
// Dof identification by quantized-coordinate hashing.
// keys: [n, 3] int64 quantized node coordinates (cell-local nodes flattened)
// out_ids: [n] int32 dof ids (dense, order of first appearance)
// Returns the number of unique dofs.
// ---------------------------------------------------------------------------
int64_t dedup_dofs(const int64_t* keys, int64_t n, int32_t* out_ids) {
  struct H {
    size_t operator()(const std::array<int64_t, 3>& k) const {
      uint64_t h = 1469598103934665603ull;
      for (int i = 0; i < 3; ++i) {
        h ^= (uint64_t)k[i];
        h *= 1099511628211ull;
      }
      return (size_t)h;
    }
  };
  std::unordered_map<std::array<int64_t, 3>, int32_t, H> map;
  map.reserve((size_t)n);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::array<int64_t, 3> k{keys[i * 3], keys[i * 3 + 1], keys[i * 3 + 2]};
    auto it = map.find(k);
    if (it == map.end()) {
      map.emplace(k, next);
      out_ids[i] = next;
      ++next;
    } else {
      out_ids[i] = it->second;
    }
  }
  return next;
}

// ---------------------------------------------------------------------------
// Structured box mesh cell array generation (basix vertex order), the
// benchmark::create_hex_mesh analogue (demo/gpu_cg/mesh.hpp:115-175).
// out_cells: [nx*ny*nz, 8] int64 vertex ids, x slowest.
// ---------------------------------------------------------------------------
void box_cells(int64_t nx, int64_t ny, int64_t nz, int64_t* out_cells) {
  const int64_t sy = nz + 1, sx = (ny + 1) * (nz + 1);
  static const int off[8][3] = {{0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
                                {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1}};
  int64_t c = 0;
  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j)
      for (int64_t k = 0; k < nz; ++k, ++c)
        for (int v = 0; v < 8; ++v)
          out_cells[c * 8 + v] =
              (i + off[v][0]) * sx + (j + off[v][1]) * sy + (k + off[v][2]);
}

}  // extern "C"
