// tomonative.cpp — native CPU engine for tomojax.
//
// The framework's counterpart of the reference's native CPU layer
// (reference tomofusion/cpu/utils/ctvlib.cpp: Eigen sparse row-action
// solvers over an exact ray-traced measurement matrix, OpenMP over
// slices; and cpu/utils/pytvlib.py parallelRay: the Siddon-style matrix
// generator, which the reference builds slowly in Python).
//
// Components:
//   * build_ray_matrix : exact parallel-beam intersection-length matrix
//     (Siddon), OpenMP-parallel over angles. Row index = angle*Nray+ray
//     (angle-major, matching the reference sinogram layout).
//   * csr_* : CSR matvec (forward projection), transpose matvec
//     (backprojection), row norms, row/col sums — OpenMP over slices.
//   * art_sweep : true sequential Kaczmarz over rays (row-action),
//     OpenMP over the independent slice batch.
//   * sirt_sweep : Landweber/Cimmino-weighted SIRT (ctvlib.cpp:205-251).
//   * poisson_noise : mean-preserving Poisson corruption
//     (tomoengine.cpp:471-484 semantics).
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Exact ray-tracing matrix (Siddon): returns nnz, fills COO triplets.
// Caller provides buffers of capacity max_nnz (2*n per ray is enough).
// ---------------------------------------------------------------------------
int64_t build_ray_matrix(int32_t n, const double* angles_deg, int32_t nproj,
                         int64_t max_nnz, int64_t* rows, int64_t* cols,
                         float* vals) {
  const double half = n / 2.0;
  std::vector<std::vector<int64_t>> trows(nproj), tcols(nproj);
  std::vector<std::vector<float>> tvals(nproj);

#pragma omp parallel for schedule(dynamic)
  for (int32_t a = 0; a < nproj; ++a) {
    const double ang = angles_deg[a] * M_PI / 180.0;
    double dx = -std::sin(ang), dy = std::cos(ang);
    if (std::fabs(dx) < 1e-10) dx = 0.0;
    if (std::fabs(dy) < 1e-10) dy = 0.0;
    std::vector<double> ts, xs, ys;
    ts.reserve(2 * (n + 1));
    auto& r = trows[a];
    auto& c = tcols[a];
    auto& v = tvals[a];
    for (int32_t j = 0; j < n; ++j) {
      const double off = -(n - 1.0) / 2.0 + j;
      double ox = std::cos(ang) * off, oy = std::sin(ang) * off;
      if (std::fabs(ox) < 1e-8) ox = 0.0;
      if (std::fabs(oy) < 1e-8) oy = 0.0;
      // Grazing top/right boundary rays are dropped (reference
      // cpu/utils/pytvlib.py:88-92).
      if ((dy == 0.0 && std::fabs(oy - half) < 1e-15) ||
          (dx == 0.0 && std::fabs(ox - half) < 1e-15))
        continue;
      ts.clear();
      xs.clear();
      ys.clear();
      for (int32_t g = 0; g <= n; ++g) {
        const double gl = -half + g;
        if (dx != 0.0) {
          const double t = (gl - ox) / dx;
          ts.push_back(t);
          xs.push_back(gl);
          ys.push_back(oy + dy * t);
        }
        if (dy != 0.0) {
          const double t = (gl - oy) / dy;
          ts.push_back(t);
          xs.push_back(ox + dx * t);
          ys.push_back(gl);
        }
      }
      // sort crossings by ray parameter
      std::vector<int32_t> idx(ts.size());
      for (size_t k = 0; k < idx.size(); ++k) idx[k] = (int32_t)k;
      std::sort(idx.begin(), idx.end(),
                [&](int32_t p, int32_t q) { return ts[p] < ts[q]; });
      double px = 0, py = 0;
      bool have_prev = false;
      for (int32_t k : idx) {
        const double x = xs[k], y = ys[k];
        if (x < -half - 1e-12 || x > half + 1e-12 || y < -half - 1e-12 ||
            y > half + 1e-12)
          continue;
        if (have_prev) {
          if (std::fabs(x - px) <= 1e-8 && std::fabs(y - py) <= 1e-8) continue;
          const double seg = std::hypot(x - px, y - py);
          if (seg > 0) {
            double mx = 0.5 * (x + px), my = 0.5 * (y + py);
            if (std::fabs(mx) < 1e-10) mx = 0.0;
            if (std::fabs(my) < 1e-10) my = 0.0;
            const int64_t pr = (int64_t)std::floor(half - my);
            const int64_t pc = (int64_t)std::floor(mx + half);
            if (pr >= 0 && pr < n && pc >= 0 && pc < n) {
              r.push_back((int64_t)a * n + j);
              c.push_back(pr * n + pc);
              v.push_back((float)seg);
            }
          }
        }
        px = x;
        py = y;
        have_prev = true;
      }
    }
  }

  int64_t nnz = 0;
  for (int32_t a = 0; a < nproj; ++a) {
    const int64_t m = (int64_t)trows[a].size();
    if (nnz + m > max_nnz) return -1;  // caller buffer too small
    std::memcpy(rows + nnz, trows[a].data(), m * sizeof(int64_t));
    std::memcpy(cols + nnz, tcols[a].data(), m * sizeof(int64_t));
    std::memcpy(vals + nnz, tvals[a].data(), m * sizeof(float));
    nnz += m;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// CSR utilities. Matrix is (nrow x ncol); x is a batch (ns, ncol) row-major;
// projections (ns, nrow).
// ---------------------------------------------------------------------------
void csr_fp(const int64_t* indptr, const int64_t* indices, const float* data,
            int64_t nrow, int64_t ncol, const float* x, int64_t ns,
            float* out) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    for (int64_t r = 0; r < nrow; ++r) {
      const float* xs = x + s * ncol;
      double acc = 0.0;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        acc += (double)data[k] * xs[indices[k]];
      out[s * nrow + r] = (float)acc;
    }
  }
}

void csr_bp(const int64_t* indptr, const int64_t* indices, const float* data,
            int64_t nrow, int64_t ncol, const float* y, int64_t ns,
            float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    float* os = out + s * ncol;
    std::memset(os, 0, ncol * sizeof(float));
    const float* ys = y + s * nrow;
    for (int64_t r = 0; r < nrow; ++r) {
      const float yr = ys[r];
      if (yr == 0.0f) continue;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        os[indices[k]] += data[k] * yr;
    }
  }
}

void csr_row_norms_sq(const int64_t* indptr, const float* data, int64_t nrow,
                      float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < nrow; ++r) {
    double acc = 0.0;
    for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
      acc += (double)data[k] * data[k];
    out[r] = (float)acc;
  }
}

void csr_col_sums(const int64_t* indptr, const int64_t* indices,
                  const float* data, int64_t nrow, int64_t ncol, float* out) {
  std::memset(out, 0, ncol * sizeof(float));
  for (int64_t r = 0; r < nrow; ++r)
    for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
      out[indices[k]] += data[k];
}

// Row-action Kaczmarz sweep over rays in `order`; OpenMP over slices
// (reference ctvlib.cpp:137-191 ART/randART).
void art_sweep(const int64_t* indptr, const int64_t* indices,
               const float* data, const float* row_nsq, int64_t nrow,
               int64_t ncol, const int64_t* order, int64_t norder, float beta,
               const float* b, int64_t ns, float* x) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    float* xs = x + s * ncol;
    const float* bs = b + s * nrow;
    for (int64_t oi = 0; oi < norder; ++oi) {
      const int64_t r = order[oi];
      const float nsq = row_nsq[r];
      if (nsq <= 0.0f) continue;
      double dot = 0.0;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        dot += (double)data[k] * xs[indices[k]];
      const float coef = beta * (bs[r] - (float)dot) / nsq;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        xs[indices[k]] += coef * data[k];
    }
  }
}

// SIRT sweep: mode 0 = Landweber x += beta A^T(b-Ax);
// mode 1 = Cimmino x += (beta/nrow) A^T M (b-Ax), M = 1/||a_r||^2
// (reference ctvlib.cpp:205-251).
void sirt_sweep(const int64_t* indptr, const int64_t* indices,
                const float* data, const float* row_nsq, int64_t nrow,
                int64_t ncol, float beta, int32_t mode, const float* b,
                int64_t ns, float* x, float* scratch_resid) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    float* xs = x + s * ncol;
    const float* bs = b + s * nrow;
    float* rs = scratch_resid + s * nrow;
    for (int64_t r = 0; r < nrow; ++r) {
      double dot = 0.0;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        dot += (double)data[k] * xs[indices[k]];
      float w = 1.0f;
      if (mode == 1) w = row_nsq[r] > 0 ? 1.0f / row_nsq[r] / (float)nrow : 0.0f;
      rs[r] = beta * w * (bs[r] - (float)dot);
    }
    for (int64_t r = 0; r < nrow; ++r) {
      const float yr = rs[r];
      if (yr == 0.0f) continue;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        xs[indices[k]] += data[k] * yr;
    }
  }
}

// ASTRA-weighted SIRT sweep: x <- clamp0(x + C A^T R (b - A x)) with
// R = 1/row-sums, C = 1/col-sums (precomputed by the caller) — the
// weighting the reference's GPU engine gets from ASTRA's CCudaSirtAlgorithm
// with min-constraint 0 (tomoengine.cpp:181-205). Gives the native engine
// the same SIRT flavor the GPU/FISTA paths use, so JAX convergence traces
// can be pinned against the exact-matrix operator.
void sirt_astra_sweep(const int64_t* indptr, const int64_t* indices,
                      const float* data, const float* inv_row,
                      const float* inv_col, int64_t nrow, int64_t ncol,
                      const float* b, int64_t ns, float* x,
                      float* scratch_resid, float* scratch_col) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < ns; ++s) {
    float* xs = x + s * ncol;
    const float* bs = b + s * nrow;
    float* rs = scratch_resid + s * nrow;
    float* us = scratch_col + s * ncol;
    for (int64_t r = 0; r < nrow; ++r) {
      double dot = 0.0;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        dot += (double)data[k] * xs[indices[k]];
      rs[r] = (bs[r] - (float)dot) * inv_row[r];
    }
    std::memset(us, 0, ncol * sizeof(float));
    for (int64_t r = 0; r < nrow; ++r) {
      const float yr = rs[r];
      if (yr == 0.0f) continue;
      for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k)
        us[indices[k]] += data[k] * yr;
    }
    for (int64_t c = 0; c < ncol; ++c) {
      const float v = xs[c] + inv_col[c] * us[c];
      xs[c] = v < 0.0f ? 0.0f : v;
    }
  }
}

// ---------------------------------------------------------------------------
// 3D TV value + TV gradient descent (reference cpu ctvlib.cpp:336-462).
// Volume layout: (nx, ny, nz) row-major, nx = slice axis. Periodic wrap in
// all axes, eps = 1e-8 (the CPU engine's value; the GPU kernels use 1e-6).
// Deviations from the literal reference (documented, intended math kept):
//   * ctvlib.cpp's `float tv;` / `float tv_norm;` reduction accumulators
//     are uninitialized (UB) and tv_norm is never reset between the ng
//     descent steps — we initialize to zero and reset per step.
//   * ctvlib.cpp:386,391 index `kp = (k+1)%ny` / loop `k < ny` use ny for
//     the z axis; harmless for the square slices the engine requires
//     (ny == nz enforced by the wrapper).
// ---------------------------------------------------------------------------
double tv_value_3d(const float* x, int64_t nx, int64_t ny, int64_t nz) {
  const double eps = 1e-8;
  double tv = 0.0;
#pragma omp parallel for reduction(+ : tv) schedule(static)
  for (int64_t i = 0; i < nx; ++i) {
    const int64_t ip = (i + 1) % nx;
    for (int64_t j = 0; j < ny; ++j) {
      const int64_t jp = (j + 1) % ny;
      for (int64_t k = 0; k < nz; ++k) {
        const int64_t kp = (k + 1) % nz;
        const double c = x[(i * ny + j) * nz + k];
        const double di = c - x[(ip * ny + j) * nz + k];
        const double dj = c - x[(i * ny + jp) * nz + k];
        const double dk = c - x[(i * ny + j) * nz + kp];
        tv += std::sqrt(eps + di * di + dj * dj + dk * dk);
      }
    }
  }
  return tv;
}

// ng steps of  x -= dPOCS * grad/||grad||  with the 4-term divided-
// difference isotropic TV subgradient, then positivity (ctvlib.cpp:406-462
// intended math; batch of `ns` independent volumes, norm per volume).
void tv_gd_3d(float* x, int64_t ns, int64_t nx, int64_t ny, int64_t nz,
              int32_t ng, float dpocs, float* grad_scratch) {
  const double eps = 1e-8;
  const int64_t vol = nx * ny * nz;
  for (int64_t s = 0; s < ns; ++s) {
    float* xs = x + s * vol;
    float* g = grad_scratch;
    for (int32_t it = 0; it < ng; ++it) {
      double nsq = 0.0;
#pragma omp parallel for reduction(+ : nsq) schedule(static)
      for (int64_t i = 0; i < nx; ++i) {
        const int64_t ip = (i + 1) % nx, im = (i - 1 + nx) % nx;
        for (int64_t j = 0; j < ny; ++j) {
          const int64_t jp = (j + 1) % ny, jm = (j - 1 + ny) % ny;
          for (int64_t k = 0; k < nz; ++k) {
            const int64_t kp = (k + 1) % nz, km = (k - 1 + nz) % nz;
            auto at = [&](int64_t a, int64_t b, int64_t c) -> double {
              return xs[(a * ny + b) * nz + c];
            };
            const double c0 = at(i, j, k);
            const double v1n = 3.0 * c0 - at(ip, j, k) - at(i, jp, k) -
                               at(i, j, kp);
            double d;
            d = c0 - at(ip, j, k);
            double v1d = d * d;
            d = c0 - at(i, jp, k);
            v1d += d * d;
            d = c0 - at(i, j, kp);
            v1d += d * d;
            v1d = std::sqrt(eps + v1d);
            const double v2n = c0 - at(im, j, k);
            d = at(im, j, k) - c0;
            double v2d = d * d;
            d = at(im, j, k) - at(im, jp, k);
            v2d += d * d;
            d = at(im, j, k) - at(im, j, kp);
            v2d += d * d;
            v2d = std::sqrt(eps + v2d);
            const double v3n = c0 - at(i, jm, k);
            d = at(i, jm, k) - at(ip, jm, k);
            double v3d = d * d;
            d = at(i, jm, k) - c0;
            v3d += d * d;
            d = at(i, jm, k) - at(i, jm, kp);
            v3d += d * d;
            v3d = std::sqrt(eps + v3d);
            const double v4n = c0 - at(i, j, km);
            d = at(i, j, km) - at(ip, j, km);
            double v4d = d * d;
            d = at(i, j, km) - at(i, jp, km);
            v4d += d * d;
            d = at(i, j, km) - c0;
            v4d += d * d;
            v4d = std::sqrt(eps + v4d);
            const double gv = v1n / v1d + v2n / v2d + v3n / v3d + v4n / v4d;
            g[(i * ny + j) * nz + k] = (float)gv;
            nsq += gv * gv;
          }
        }
      }
      const float scale = dpocs / (float)std::sqrt(nsq);
#pragma omp parallel for schedule(static)
      for (int64_t p = 0; p < vol; ++p) xs[p] -= scale * g[p];
    }
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < vol; ++p)
      if (xs[p] < 0.0f) xs[p] = 0.0f;
  }
}

// Mean-preserving Poisson noise (tomoengine.cpp:471-484 semantics).
void poisson_noise(float* b, int64_t size, int64_t n_counts, uint64_t seed) {
  double total = 0.0;
  for (int64_t i = 0; i < size; ++i) total += b[i];
  const double scale = (double)n_counts * size / total;
#pragma omp parallel
  {
#ifdef _OPENMP
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    std::mt19937_64 gen(seed + 0x9e3779b97f4a7c15ULL * (tid + 1));
#pragma omp for schedule(static)
    for (int64_t i = 0; i < size; ++i) {
      std::poisson_distribution<long> dist(b[i] * scale);
      b[i] = (float)dist(gen) / (float)scale;
    }
  }
}

int32_t omp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
