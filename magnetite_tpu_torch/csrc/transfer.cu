// Level-0 AMG transfer pair on Hopper (sm_90a): the tentative prolongator
// P0 and its exact adjoint P0^T of the factored smoothed-aggregation
// transfer (magnetite_tpu/fem/amg.py, AMGSetup.fast0).
//
//   prolong:  u0[i, n] = sum_j p0[n, i, j] * ec[agg[n], j]      ec [n1, 3] -> u0 [2, n0]
//   restrict: rc[a, i] = sum_k sum_j pt0_vals[a, k, i, j] * tmp[j, pt0_cols[a, k]]
//                                                              tmp [2, n0] -> rc [n1, 3]
//
// Replace magnetite_tpu/pallas/transfer_kernel.py::_prolong_kernel and
// ::_restrict_kernel (launched by _apply_prolong / _apply_restrict, built by
// make_plan_transfers). The TPU pair turns the gathers into radix one-hot
// matmuls over a window plan because gathers are slow there; Hopper gathers
// through L1/L2 directly, so neither the plan nor the one-hot is needed.
//
// What bounds them: device-memory bandwidth. Prolong streams p0 (6 values per
// fine node) and writes u0 (2 per node); the ec gather hits a coarse vector
// ~1/6 the size of p0 that stays in L2. Restrict streams pt0_vals (6 values
// per member) and gathers tmp at the member columns, which are spatially
// clustered (aggregates are cells of nearby nodes). Design: one thread per
// fine node for prolong (coalesced p0 / u0), one thread per aggregate for
// restrict, which sums its own members in a fixed order: no atomics, so the
// result is deterministic run to run. ELL padding (col 0, zero values)
// contributes exactly 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) prolong0_kernel(
    const T* __restrict__ ec, const int* __restrict__ agg,
    const T* __restrict__ p0, T* __restrict__ u0, int64_t n0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n0) return;
  const int64_t a = agg[i];
  const T e0 = ec[3 * a], e1 = ec[3 * a + 1], e2 = ec[3 * a + 2];
  const T* p = p0 + 6 * i;
  u0[i] = p[0] * e0 + p[1] * e1 + p[2] * e2;
  u0[n0 + i] = p[3] * e0 + p[4] * e1 + p[5] * e2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) restrict0_kernel(
    const T* __restrict__ tmp, const int* __restrict__ cols,
    const T* __restrict__ vals, T* __restrict__ rc, int64_t n0, int64_t n1,
    int w0) {
  const int64_t a = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a >= n1) return;
  T r0 = T(0), r1 = T(0), r2 = T(0);
  const int* c = cols + a * w0;
  const T* v = vals + a * w0 * 6;
  for (int k = 0; k < w0; ++k, v += 6) {
    const int64_t col = c[k];
    const T t0 = tmp[col], t1 = tmp[n0 + col];
    r0 += v[0] * t0 + v[1] * t1;
    r1 += v[2] * t0 + v[3] * t1;
    r2 += v[4] * t0 + v[5] * t1;
  }
  rc[3 * a] = r0;
  rc[3 * a + 1] = r1;
  rc[3 * a + 2] = r2;
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Return a cudaError_t code (0 = launched).
extern "C" int mt_prolong0(int dtype, const void* ec, const void* agg,
                           const void* p0, void* u0, int64_t n0, void* stream) {
  if (n0 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    prolong0_kernel<float><<<grid_for(n0), kThreads, 0, s>>>(
        static_cast<const float*>(ec), static_cast<const int*>(agg),
        static_cast<const float*>(p0), static_cast<float*>(u0), n0);
  } else if (dtype == 1) {
    prolong0_kernel<double><<<grid_for(n0), kThreads, 0, s>>>(
        static_cast<const double*>(ec), static_cast<const int*>(agg),
        static_cast<const double*>(p0), static_cast<double*>(u0), n0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mt_restrict0(int dtype, const void* tmp, const void* cols,
                            const void* vals, void* rc, int64_t n0, int64_t n1,
                            int w0, void* stream) {
  if (n0 <= 0 || n1 <= 0 || w0 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    restrict0_kernel<float><<<grid_for(n1), kThreads, 0, s>>>(
        static_cast<const float*>(tmp), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<float*>(rc), n0, n1, w0);
  } else if (dtype == 1) {
    restrict0_kernel<double><<<grid_for(n1), kThreads, 0, s>>>(
        static_cast<const double*>(tmp), static_cast<const int*>(cols),
        static_cast<const double*>(vals), static_cast<double*>(rc), n0, n1, w0);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
