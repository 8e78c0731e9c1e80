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
// ~1/6 the size of p0 that stays in L2. One thread per fine node (coalesced
// p0 / u0). At the 1M plate that is 18.6 MB in f32, so a call is mostly the
// card's fixed cost per kernel (~7 us on an H100 with the timer of
// chip_smoke.py) plus the bytes at ~2.8 TB/s, and this design already sits on
// that line: threads of 4 (f32) / 2 (f64) consecutive nodes with 16-byte
// loads, and warps staging their p0 blocks through shared memory for
// coalesced reads, measured no faster in the same call (PERF.md).
//
// Restrict streams pt0_vals (6 values per member, w0 members per aggregate,
// 33 MB in f64 at the 1M plate) and gathers tmp at the member columns. One
// thread per aggregate (the first design) ran 48,553 threads at the 1M
// plate, ~11 warps per SM, each thread walking its own 84 contiguous
// values: neighbouring threads 672 B apart, every warp load touching 32
// sectors. Now a team of `team` threads (the power of two >= w0, at most
// 32: 16 at w0 = 14) takes one aggregate, thread k its members k, k + team,
// ...: the team's column and value reads are contiguous (one member's
// values in 16-byte double2 / 8-byte float2 loads where the array is
// aligned), 16x as many threads are in flight, and each thread's three
// partial sums meet in a __shfl_xor_sync tree of fixed order, lane 0 of the
// team writing rc[a]. No atomics, so the result is the same from run to
// run; only the summation order differs from the plain version. Measured
// on an H100 at the 1M plate, device time, the three in one call
// (PERF.md): 0.028 ms f64 / 0.018 ms f32, 47% / 39% of the bound, against
// 0.035 / 0.024 ms for one thread per aggregate and 0.044 / 0.037 ms for
// cuSPARSE's CSR SpMV of P0^T. ELL padding (col 0, zero values)
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

// one aggregate's member values: 6 per member, as three pairs where the
// array is 16-byte (f64) / 8-byte (f32) aligned
__device__ __forceinline__ void load6(const double* v, bool pairs, double (&p)[6]) {
  if (pairs) {
    const double2* v2 = reinterpret_cast<const double2*>(v);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const double2 x = __ldg(v2 + e);
      p[2 * e] = x.x, p[2 * e + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 6; ++e) p[e] = __ldg(v + e);
  }
}
__device__ __forceinline__ void load6(const float* v, bool pairs, float (&p)[6]) {
  if (pairs) {
    const float2* v2 = reinterpret_cast<const float2*>(v);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float2 x = __ldg(v2 + e);
      p[2 * e] = x.x, p[2 * e + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 6; ++e) p[e] = __ldg(v + e);
  }
}

// Thread k of the team of aggregate a sums members k, k + team, ...; the
// team (a power of two dividing 32, aligned in its warp) then reduces its
// partial sums by xor shuffles. Every thread of a warp reaches the shuffles
// (a thread past n1 carries zeros), so the full mask holds.
template <typename T>
__global__ void __launch_bounds__(kThreads) restrict0_kernel(
    const T* __restrict__ tmp, const int* __restrict__ cols,
    const T* __restrict__ vals, T* __restrict__ rc, int64_t n0, int64_t n1,
    int w0, int team_log2) {
  const int team = 1 << team_log2;
  const int64_t a = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> team_log2;
  const int k = threadIdx.x & (team - 1);
  const bool pairs = (reinterpret_cast<uintptr_t>(vals) & (2 * sizeof(T) - 1)) == 0;
  T r0 = T(0), r1 = T(0), r2 = T(0);
  if (a < n1) {
    const int* c = cols + a * w0;
    const T* v = vals + a * w0 * 6;
    for (int m = k; m < w0; m += team) {
      const int64_t col = __ldg(c + m);
      const T t0 = __ldg(tmp + col), t1 = __ldg(tmp + n0 + col);
      T p[6];
      load6(v + 6 * m, pairs, p);
      r0 += p[0] * t0 + p[1] * t1;
      r1 += p[2] * t0 + p[3] * t1;
      r2 += p[4] * t0 + p[5] * t1;
    }
  }
  for (int off = team >> 1; off > 0; off >>= 1) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, off);
    r1 += __shfl_xor_sync(0xffffffffu, r1, off);
    r2 += __shfl_xor_sync(0xffffffffu, r2, off);
  }
  if (k == 0 && a < n1) {
    rc[3 * a] = r0;
    rc[3 * a + 1] = r1;
    rc[3 * a + 2] = r2;
  }
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

// The team size comes from w0: the power of two >= w0, at most 32 (wider
// aggregates loop within their team).
extern "C" int mt_restrict0(int dtype, const void* tmp, const void* cols,
                            const void* vals, void* rc, int64_t n0, int64_t n1,
                            int w0, void* stream) {
  if (n0 <= 0 || n1 <= 0 || w0 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int team_log2 = 0;
  while ((1 << team_log2) < w0 && team_log2 < 5) ++team_log2;
  const unsigned grid = grid_for(n1 << team_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    restrict0_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(tmp), static_cast<const int*>(cols),
        static_cast<const float*>(vals), static_cast<float*>(rc), n0, n1, w0, team_log2);
  } else if (dtype == 1) {
    restrict0_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(tmp), static_cast<const int*>(cols),
        static_cast<const double*>(vals), static_cast<double*>(rc), n0, n1, w0, team_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
