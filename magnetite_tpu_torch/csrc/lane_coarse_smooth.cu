// Fused coarsest-level solve of the structured material sweep's lane
// V-cycle on Hopper (sm_90a): `sweeps` damped block-Jacobi sweeps from
// zero, in one launch,
//
//   e = omega D_b^-1 r,  then (sweeps - 1) times  e += omega D_b^-1 (r - K(w_b) e)
//
// per lane b, with K(w_b) = wa_b Sa + wb_b Sb + wc_b Sc + Sfix the lane's
// 9-point 2x2-block stencil on the coarsest grid (rows outside it read
// zero, columns wrap or read zero) and D_b^-1 its inverse center blocks.
// Operands: the level's stencils packed [R, C, 9, 2, 2, 4] ((Sa, Sb, Sc,
// Sfix) innermost; lane_stencil_kernel.py::pack_lane_stencils), dinv [2, 2,
// R, C, B], the weights [B] each, r and e [2, R, C, B] (B minormost).
//
// No TPU kernel stands behind it: the JAX package writes this loop in
// plain XLA (magnetite_tpu/parallel/sweep.py::_lane_material_vcycle,
// smooth() at :1055 on the coarsest level, :1064; 48 sweeps, omega 0.7).
// Before this kernel the port ran it as 47 launches of the S = 3 lane
// stencil kernel and ~9 torch passes each, per V-cycle: at the 9x17 level
// the launches cost 24-43 us each against a ~7 us floor, and the host
// enqueue of ~470 launches left the card idle 44% of the material sweep.
//
// What bounds it: operations. Each (node, lane) does 8 flops per stencil
// term inside the grid and sweep, plus the residual, the 2x2 apply and the
// update; the bytes (r, dinv, the weights, the four stencils in, e out)
// are read once. At 9x17, B = 4,096, 48 sweeps: ~2.4 GFLOP, 0.035 ms of 67
// TFLOP/s in f32 and 0.070 ms of 34 TFLOP/s in f64, against 0.006 / 0.012
// ms of bytes.
//
// Design. Lanes are independent, so a block owns a slab of kSlab = 2 lanes
// and every node of the level, one thread per (node, lane), and runs all
// sweeps inside the launch. Each thread builds its node's combined 2x2
// blocks for its lane once per slab, in the plain version's order (the
// coefficients combined first, as lane_material_matvec_plain does), and
// keeps the 36 of them, its 4 inverse-block entries, its r and its e in
// registers: a sweep is then 36 FMAs per (node, lane), not 144. e lives in
// shared memory, double-buffered with one barrier per sweep, as [padded
// node][lane][component] with a zero border row above and below and a
// zero column each side (wrapped grids index their columns modulo
// instead), so a thread reads each neighbour's two components as one 8- or
// 16-byte load and a warp's 32 threads read one contiguous run. The blocks
// are persistent: as many as fit on the card at once (the occupancy
// query), each walking slabs blockIdx.x, + gridDim.x, ... It stages the
// level's four stencils in shared memory once (a node's 144 values padded
// by 16 bytes), and while a slab sweeps, cp.async brings the next slab's
// dinv and r (strided by B in device memory) into a shared buffer, so a
// slab starts without waiting on device memory. A level runs here when
// its slab fits one block (lane_coarse_plan: at most 320 threads, the
// stencils, e and the buffer in 227 KB of shared memory): the 9x17 and
// the wrapped 9x16 levels fit; 17x33 does not, and runs per sweep through
// the S = 3 kernel.
//
// ptxas (sm_90a): f32 79 registers, f64 146, no spills; at 9x17 a block
// is 306 threads (10 warps) with 105 KB (f32) / 207 KB (f64) of shared
// memory: two blocks per SM in f32, one in f64.
//
// Measured at 9x17, 4,096 lanes, NVIDIA H100 80GB HBM3, 700 W (PERF.md §6):
// f32 0.159 ms, f64 0.296 ms (22% / 24% of the bound), against 6.8-11.9 ms
// for the unfused sequence it replaced (its device time includes the waits
// for the host to enqueue ~470 launches). With one sweep the launch takes
// 0.048 / 0.072 ms (scripts/lane_stencil_variants.py); the sweeps then cost
// ~2.4 / 4.8 us each over the grid, with one barrier each and 10 warps (f64)
// to 20 (f32) per SM to hide the shared-memory and FMA latencies. A first
// version with a block per slab and the stencils read from L2 ran 0.168 /
// 0.378 ms, its fixed part 0.052 / 0.128 ms.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "per_device.cuh"

namespace {

constexpr int kSlab = 2;          // lanes per block
constexpr int kMaxThreads = 320;  // nodes x kSlab of the largest level that fits
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  a = q.x;
  b = q.y;
}
__device__ __forceinline__ void ld2(const double* p, double& a, double& b) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  a = q.x;
  b = q.y;
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}

// A node's 144 stencil values in shared memory, padded by 16 bytes.
template <typename T>
struct Stage {
  static constexpr int kStride = 144 + 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lane_coarse_smooth3_kernel(
    const T* __restrict__ packed, const T* __restrict__ dinv, const T* __restrict__ wa,
    const T* __restrict__ wb, const T* __restrict__ wc, const T* __restrict__ r,
    T* __restrict__ e_out, int rows, int cols, int64_t nb, int sweeps, T omega, bool wrap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nodes = rows * cols;
  constexpr int kStride = Stage<T>::kStride;
  T* st = reinterpret_cast<T*>(smem_raw);  // the stencils, [nodes][kStride]
  T* buf = st + nodes * kStride;           // e, double-buffered
  const int cp = cols + 2;
  const int per_buf = (rows + 2) * cp * kSlab * 2;
  T* pf = buf + 2 * per_buf;  // [6][blockDim]: a slab's dinv and r, brought ahead
  {
    constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
    const int n16 = nodes * (144 / kPer16);
    for (int k = threadIdx.x; k < n16; k += blockDim.x) {
      const int node = k / (144 / kPer16), part = k % (144 / kPer16);
      cp_async16(st + node * kStride + part * kPer16, packed + node * 144 + part * kPer16);
    }
  }
  for (int k = threadIdx.x; k < 2 * per_buf; k += blockDim.x) buf[k] = T(0);
  const int node = threadIdx.x / kSlab;
  const int sl = threadIdx.x % kSlab;
  const int64_t plane = static_cast<int64_t>(nodes) * nb;
  int rowb = 0;
  int colp[3] = {0, 0, 0};
  if (node < nodes) {
    const int rn = node / cols;
    const int c = node % cols;
    rowb = (rn + 1) * cp;
    if (wrap) {
      colp[0] = (c == 0 ? cols - 1 : c - 1) + 1;
      colp[2] = (c == cols - 1 ? 0 : c + 1) + 1;
    } else {
      colp[0] = c;
      colp[2] = c + 2;
    }
    colp[1] = c + 1;
  }
  const int self = ((rowb + colp[1]) * kSlab + sl) * 2;
  const int64_t slabs = (nb + kSlab - 1) / kSlab;
  auto prefetch = [&](int64_t slab) {
    const int64_t lane = slab * kSlab + sl;
    if (node < nodes && lane < nb) {
      const int64_t at = node * nb + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async_small<sizeof(T)>(pf + q * blockDim.x + threadIdx.x, dinv + q * plane + at);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cp_async_small<sizeof(T)>(pf + (4 + i) * blockDim.x + threadIdx.x, r + i * plane + at);
    }
  };
  prefetch(blockIdx.x);
  cp_async_commit();
  for (int64_t slab = blockIdx.x; slab < slabs; slab += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the stencils (first slab), this slab's dinv and r
    const int64_t lane = slab * kSlab + sl;
    const bool active = node < nodes && lane < nb;
    T coef[9][2][2];
    T di[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
    T rr[2] = {T(0), T(0)};
    if (active) {
      di[0][0] = pf[threadIdx.x];
      di[0][1] = pf[blockDim.x + threadIdx.x];
      di[1][0] = pf[2 * blockDim.x + threadIdx.x];
      di[1][1] = pf[3 * blockDim.x + threadIdx.x];
      rr[0] = pf[4 * blockDim.x + threadIdx.x];
      rr[1] = pf[5 * blockDim.x + threadIdx.x];
      const T w0 = __ldg(wa + lane), w1 = __ldg(wb + lane), w2 = __ldg(wc + lane);
      const T* cb = st + node * kStride;
#pragma unroll
      for (int s = 0; s < 9; ++s)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const T* q = cb + (s * 4 + i * 2 + j) * 4;
            coef[s][i][j] = q[0] * w0 + q[1] * w1 + q[2] * w2 + q[3];
          }
    }
    __syncthreads();  // every thread has its dinv and r: the buffer takes the next slab's
    if (slab + gridDim.x < slabs) prefetch(slab + gridDim.x);
    cp_async_commit();
    T e0 = omega * (di[0][0] * rr[0] + di[0][1] * rr[1]);
    T e1 = omega * (di[1][0] * rr[0] + di[1][1] * rr[1]);
    if (active) st2(buf + self, e0, e1);
    __syncthreads();
    for (int k = 1; k < sweeps; ++k) {
      const T* cur = buf + ((k - 1) & 1) * per_buf;
      T* nxt = buf + (k & 1) * per_buf;
      if (active) {
        T y0 = T(0), y1 = T(0);
#pragma unroll
        for (int s = 0; s < 9; ++s) {
          const int at = ((rowb + (s / 3 - 1) * cp + colp[s % 3]) * kSlab + sl) * 2;
          T x0, x1;
          ld2(cur + at, x0, x1);
          y0 = y0 + coef[s][0][0] * x0 + coef[s][0][1] * x1;
          y1 = y1 + coef[s][1][0] * x0 + coef[s][1][1] * x1;
        }
        const T res0 = rr[0] - y0, res1 = rr[1] - y1;
        e0 = e0 + omega * (di[0][0] * res0 + di[0][1] * res1);
        e1 = e1 + omega * (di[1][0] * res0 + di[1][1] * res1);
        st2(nxt + self, e0, e1);
      }
      __syncthreads();
    }
    if (active) {
      e_out[node * nb + lane] = e0;
      e_out[plane + node * nb + lane] = e1;
    }
  }
}

// The stencils, e's two buffers and the dinv / r buffer.
template <typename T>
size_t smem_bytes(int rows, int cols, int threads) {
  return (static_cast<size_t>(rows) * cols * Stage<T>::kStride +
          static_cast<size_t>(2) * (rows + 2) * (cols + 2) * kSlab * 2 +
          static_cast<size_t>(6) * threads) * sizeof(T);
}

template <typename T>
int launch(const void* packed, const void* dinv, const void* wa, const void* wb, const void* wc,
           const void* r, void* e, int rows, int cols, int64_t nb, int sweeps, double omega,
           int wrap, cudaStream_t stream) {
  const int threads = (rows * cols * kSlab + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(rows, cols, threads);
  if (rows < 1 || cols < 2 || nb < 1 || sweeps < 1 || threads > kMaxThreads ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per instance and device; the occupancy query below reads the
  // allowance of the current device
  static std::atomic<bool> allowed[mt::kMaxDevices];
  const cudaError_t err = mt::once_per_device(allowed, [] {
    return cudaFuncSetAttribute(lane_coarse_smooth3_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = mt::sm_count();
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lane_coarse_smooth3_kernel<T>, threads,
                                                smem);
  const int64_t slabs = (nb + kSlab - 1) / kSlab;
  // persistent blocks: as many as fit on the card at once
  const int64_t blocks =
      std::min<int64_t>(slabs, static_cast<int64_t>(std::max(per_sm, 1)) * sms);
  lane_coarse_smooth3_kernel<T><<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(packed), static_cast<const T*>(dinv), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(wc), static_cast<const T*>(r),
      static_cast<T*>(e), rows, cols, nb, sweeps, static_cast<T>(omega), wrap != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. packed [R, C, 9, 2, 2, 4] (16-byte
// aligned), dinv [2, 2, R, C, B], wa / wb / wc [B], r and e [2, R, C, B];
// the level must fit one block (lane_coarse_plan: R * C * 2 <= 320 threads,
// 227 KB of shared memory). Returns a cudaError_t code (0 = launched).
extern "C" int mt_lane_coarse_smooth3(int dtype, int wrap, const void* packed, const void* dinv,
                                      const void* wa, const void* wb, const void* wc,
                                      const void* r, void* e, int rows, int cols, int64_t nb,
                                      int sweeps, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, omega, wrap, s);
  }
  if (dtype == 1) {
    return launch<double>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, omega, wrap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
