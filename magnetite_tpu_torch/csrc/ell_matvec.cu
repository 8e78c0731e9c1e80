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
// Design (redesigned for the all-gather path's shard shape): one thread
// per row in 704-thread blocks (a shard's 92,707 rows: 132 blocks, one an
// SM). Slot k's cols and its four block planes are each an [N] plane, so
// the 32 threads of a warp read 32 consecutive values of each (coalesced;
// every value is read once). These streams are read with
// `ld.global.nc.L1::no_allocate.L2::256B`: L1 keeps no line of them, and
// L2 fetches 256 bytes at a time from device memory. The u gather at
// cols[k, n] goes through L1/L2 as before: a Delaunay mesh's neighbours lie
// close in the mesher's node order, so a warp's gathers touch few lines.
// The sum runs over the slots in order, component 0's product before 1's,
// as the plain version's, so a call repeats bit for bit and gives the bits
// of the kernel it replaced (256-thread blocks, no hint).
//
// Measured on NVIDIA H100 80GB HBM3, 700 W, in interleaved rounds against
// the kernel it replaced (chip_smoke.py phases 22 and 25b with --baseline;
// PERF.md §6): at the all-gather shard (92,707 rows, K = 8, N_u 370,828)
// f64 0.0173 ms (was 0.0201; 51.1% of the bound, 81.7% of bound + the
// card's 0.0052 ms launch floor), f32 0.0128 (was 0.0149; 38.2%); at the
// 1M plate (500,393 rows) 0.0644 / 0.0398 ms (was 0.0675 / 0.0427; 74.3% /
// 66.0%).
//
// Tried and not kept (scripts/ell_coarse_variants.py as of commit b558abc,
// the same rounds; f64 / f32, shard then 1M plate): the same kernel in 256-thread blocks
// 0.0174 / 0.0129, 0.0656 / 0.0408 and in 128-thread blocks 0.0174 /
// 0.0129, 0.0670 / 0.0418; the slot loop unrolled 8 times 0.0179 /
// 0.0128, 0.0650 / 0.0415; an L2 evict-first policy on the streams 0.0174
// / 0.0129, 0.0656 / 0.0408; every slot's cols loaded before any gather
// 0.0172 / 0.0127, 0.0661 / 0.0412 (1-2% faster at the shard, 2.5-3%
// slower at the 1M plate: one plan for both shapes was worth more than
// that); a row split over 2 or 4 threads (thread p the slots p, p + t,
// ..., in order; the t partial sums met by __shfl_xor_sync, within
// rounding of the plain sum), in the block that deals the blocks most
// evenly over the SMs, 0.0185 / 0.0136, 0.0670 / 0.0434 (t = 2) and
// 0.0191 / 0.0146, 0.0690 / 0.0473 (t = 4): slower at every shape.
//
// No atomics, no shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 704;  // 22 warps: a shard's 92,707 rows in 132 blocks, one an SM

// A value of a stream read once (cols, the block planes): not kept in L1,
// fetched with L2's 256-byte prefetch.
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

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
    const int64_t src = ld_stream(cols + k * plane + node);
    const T* __restrict__ blk = data + 4 * k * plane + node;
    const T e00 = ld_stream(blk), e01 = ld_stream(blk + plane);
    const T e10 = ld_stream(blk + 2 * plane), e11 = ld_stream(blk + 3 * plane);
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

__global__ void launch_floor_kernel(const float* __restrict__ x, float* __restrict__ y) {
  if (threadIdx.x == 0) y[0] = x[0];
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

// The card's floor for one call: a kernel that reads one value and writes
// one (a block of 32 threads), launched as the kernels above are; timed
// beside them (chip_smoke.py, phases 22 and 25b).
extern "C" int mt_launch_floor(const void* x, void* y, void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}
