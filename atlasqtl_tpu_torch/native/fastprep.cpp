// Copy of atlasqtl_tpu/native/fastprep.cpp, the JAX package's native host
// preparation pass, kept in the PyTorch port so that it never loads the JAX
// package's library; atlasqtl_tpu_torch/native/__init__.py builds it with g++
// at first use into atlasqtl_tpu_torch/_build/ and binds it with ctypes.
//
// Native host-side data preparation for atlasqtl_tpu.
//
// TPU-native framework counterpart of the reference's host preprocessing
// (R/prepare_atlasqtl.R:57-83, R/utils.R:276-343): at mQTL scale
// (p = 300k, n = 5k) the one-time standardize / constant-column /
// duplicate-column pass over X is multi-GB and NumPy does it single-threaded
// with several temporaries.  This module does one fused multithreaded pass.
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 in the
// image); atlasqtl_tpu/io/prepare.py falls back to NumPy when the shared
// library is unavailable.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

void parallel_for(long n_items, const std::function<void(long, long)> &fn) {
  unsigned hw = std::thread::hardware_concurrency();
  long n_threads = hw ? static_cast<long>(hw) : 4;
  if (n_threads > n_items) n_threads = n_items > 0 ? n_items : 1;
  std::vector<std::thread> threads;
  long chunk = (n_items + n_threads - 1) / n_threads;
  for (long t = 0; t < n_threads; ++t) {
    long lo = t * chunk;
    long hi = lo + chunk < n_items ? lo + chunk : n_items;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto &th : threads) th.join();
}

}  // namespace

extern "C" {

// Standardize columns of the row-major n x p matrix `x` in place with the
// (n-1)-denominator sd (R scale() semantics).  Constant columns (sd == 0)
// are flagged in `is_constant` and zero-filled.  Writes per-column FNV-1a
// hashes of the standardized bytes into `hashes` for duplicate detection.
// Returns the number of constant columns.
long fastprep_standardize(double *x, long n, long p, double *col_mean,
                          double *col_sd, uint8_t *is_constant,
                          uint64_t *hashes) {
  std::vector<long> cst_count_per_thread;
  long total_cst = 0;
  std::vector<long> counts(p, 0);

  parallel_for(p, [&](long lo, long hi) {
    for (long j = lo; j < hi; ++j) {
      double mean = 0.0;
      for (long i = 0; i < n; ++i) mean += x[i * p + j];
      mean /= n;
      double ss = 0.0;
      for (long i = 0; i < n; ++i) {
        double d = x[i * p + j] - mean;
        ss += d * d;
      }
      double sd = n > 1 ? std::sqrt(ss / (n - 1)) : 0.0;
      col_mean[j] = mean;
      col_sd[j] = sd;
      uint64_t h = 1469598103934665603ULL;  // FNV-1a offset basis
      if (sd == 0.0 || !std::isfinite(sd)) {
        is_constant[j] = 1;
        counts[j] = 1;
        for (long i = 0; i < n; ++i) x[i * p + j] = 0.0;
      } else {
        is_constant[j] = 0;
        double inv = 1.0 / sd;
        for (long i = 0; i < n; ++i) {
          double v = (x[i * p + j] - mean) * inv;
          x[i * p + j] = v;
          uint64_t bits;
          std::memcpy(&bits, &v, sizeof(bits));
          h ^= bits;
          h *= 1099511628211ULL;  // FNV-1a prime
        }
      }
      hashes[j] = h;
    }
  });
  for (long j = 0; j < p; ++j) total_cst += counts[j];
  return total_cst;
}

// Exact column comparison: returns 1 if columns j1 and j2 of the row-major
// n x p matrix are bitwise equal.
int fastprep_columns_equal(const double *x, long n, long p, long j1, long j2) {
  for (long i = 0; i < n; ++i) {
    if (x[i * p + j1] != x[i * p + j2]) return 0;
  }
  return 1;
}

// Missingness statistics for the row-major n x q response matrix: writes the
// 0/1 observation mask, per-column observed counts, and NaN-aware column
// means; returns the total number of observed entries.
long fastprep_missing_stats(const double *y, long n, long q, uint8_t *mask,
                            long *col_obs, double *col_mean) {
  std::vector<long> totals(q, 0);
  parallel_for(q, [&](long lo, long hi) {
    for (long k = lo; k < hi; ++k) {
      long obs = 0;
      double mean = 0.0;
      for (long i = 0; i < n; ++i) {
        double v = y[i * q + k];
        bool ok = !std::isnan(v);
        mask[i * q + k] = ok ? 1 : 0;
        if (ok) {
          ++obs;
          mean += v;
        }
      }
      col_obs[k] = obs;
      col_mean[k] = obs > 0 ? mean / obs : 0.0;
      totals[k] = obs;
    }
  });
  long total = 0;
  for (long k = 0; k < q; ++k) total += totals[k];
  return total;
}

}  // extern "C"
