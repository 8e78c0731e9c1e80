// Single-vector block-ELL SpMV on Hopper (sm_90a), the level-0 operator of
// the ELL solve mode (fem/solve.py::EllSystem):
//
//   y[i, n] = sum_k sum_j data[k, i, j, n] * u[j, cols[k, n]]
//
// data [K, 2, 2, N] slot-major (node minormost; relaid out once at compile
// time from the assembly's [N, K, 2, 2]), cols [K, N] int32 (padding slots
// point at the row's own node and hold zero blocks), y [2, N] in the port's
// band layout and u [2, N_u], N_u >= N: the all-gather sharded path
// (parallel/sharding.py) runs a shard's N rows against the whole gathered
// field, its cols global indices. f32 and f64 instances.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function as magnetite_tpu/fem/operator.py:27 (`ell_matvec`, a gather and
// an einsum on [N, 2] fields) and leaves it to XLA; there is no
// `pallas_call`. Its plain PyTorch form materialises a gathered [N, K, 2]
// field and a [N, K, 2, 2] product per call (at the 1M-element Delaunay
// plate in f64 tens to a hundred MB each, written and read back).
//
// What bounds it: device memory. The blocks and cols are read once (4 K N
// values + 4 K N bytes), u's 2 N values at least once and y written once;
// 8 flops per slot leave the bytes the bound by ~20x even in f64.
//
// Design: one thread per node. Slot k's cols and its four block planes
// are each an [N] plane, so the 32 threads of a warp read 32 consecutive
// values of each (coalesced; every value is read once). The u gather at
// cols[k, n] goes through L1/L2: a
// Delaunay mesh's neighbours lie close in the mesher's node order, so a
// warp's gathers touch few lines. No atomics, no shared memory; the sum
// runs over the slots in order, component 0's product before 1's, as the
// plain version's, so a call repeats bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) ell_matvec_kernel(
    const T* __restrict__ data, const int* __restrict__ cols, const T* __restrict__ u,
    T* __restrict__ y, int64_t n, int64_t n_u, int width) {
  const int64_t node = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (node >= n) return;
  const int64_t plane = n;  // one [N] plane of data or cols
  const T* __restrict__ u1 = u + n_u;
  T acc0 = T(0), acc1 = T(0);
#pragma unroll 4
  for (int k = 0; k < width; ++k) {
    const int64_t src = __ldg(cols + k * plane + node);
    const T* __restrict__ blk = data + 4 * k * plane + node;
    const T e00 = __ldg(blk), e01 = __ldg(blk + plane);
    const T e10 = __ldg(blk + 2 * plane), e11 = __ldg(blk + 3 * plane);
    const T v0 = __ldg(u + src), v1 = __ldg(u1 + src);
    acc0 = acc0 + e00 * v0 + e01 * v1;
    acc1 = acc1 + e10 * v0 + e11 * v1;
  }
  y[node] = acc0;
  y[n + node] = acc1;
}

template <typename T>
int launch(const void* data, const void* cols, const void* u, void* y, int64_t n, int64_t n_u,
           int width, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  ell_matvec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols), static_cast<const T*>(u),
      static_cast<T*>(y), n, n_u, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64; n_u the length of u's rows (>= n).
// Returns a cudaError_t code (0 = launched).
extern "C" int mt_ell_matvec(int dtype, const void* data, const void* cols, const void* u,
                             void* y, int64_t n, int64_t n_u, int width, void* stream) {
  if (n <= 0 || n_u < n || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(data, cols, u, y, n, n_u, width, s);
  if (dtype == 1) return launch<double>(data, cols, u, y, n, n_u, width, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
