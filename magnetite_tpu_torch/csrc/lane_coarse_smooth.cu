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
// Without it the port runs the loop as 47 launches of the S = 3 lane
// stencil kernel and ~9 torch passes each, per V-cycle (the per-sweep
// route, lane_coarse_kernel.py).
//
// What bounds it: operations. Each (node, lane) does 8 flops per stencil
// term inside the grid and sweep, plus the residual, the 2x2 apply and the
// update; the bytes (r, dinv, the weights, the four stencils in, e out)
// are read once. At 9x17, B = 4,096, 48 sweeps: ~2.4 GFLOP, 0.035 ms of 67
// TFLOP/s in f32 and 0.070 ms of 34 TFLOP/s in f64, against 0.006 / 0.012
// ms of bytes.
//
// Design. Lanes are independent, so a block owns a slab of L lanes and
// every node of the level and runs all sweeps inside the launch; one
// thread owns M vertically adjacent nodes of one lane in one column
// (threads: lane minormost, then column, then the row group). It builds
// its nodes' combined 2x2 blocks for its lane once per slab, in the plain
// version's order (the coefficients combined first, as
// lane_material_matvec_plain does), and keeps the 36 M of them, their
// inverse blocks, r and e in registers: a sweep is 36 FMAs per (node,
// lane). e lives in shared memory, double-buffered with one barrier per
// sweep, as [padded row][padded column][lane][component] with a zero
// border row above, M zero rows below (a thread whose group holds fewer
// than M rows reads them without a guard) and a zero column each side
// (wrapped grids index their columns modulo instead), so a thread reads
// each neighbour's two components as one 8- or 16-byte load and a warp
// reads contiguous runs. A thread reads the (M + 2) x 3 neighbours its M
// nodes touch once each, for all of the nodes that use them: per node a
// sweep moves (M + 2) x 3 / M loads through shared memory, 5 at M = 3
// where a thread per node moved 9, and shared-memory bandwidth was what a
// sweep of the one-node design waited on. The blocks are persistent (as
// many as fit on the card, the occupancy query), each walking slabs
// blockIdx.x, + gridDim.x, ...; a block stages the level's four stencils
// in shared memory once (a node's 144 values padded by 16 bytes, read as
// 16-byte vectors when a slab builds its blocks), and while a slab sweeps,
// cp.async brings the next slab's dinv and r (lanes contiguous in device
// memory) into a shared buffer.
//
// Geometries (M, L), in the order a level takes them (MT_COARSE_F32 /
// MT_COARSE_F64; lane_coarse_plan mirrors them): f32 (3, 7), 357 threads
// at 9x17 in a 384-thread bound, which ptxas gives 167 registers and no
// spill (a bound past 384 threads allots registers for 16 warps: (3, 8)
// got 128 and spilled 184 bytes, and ran slower than the one-node design);
// f64 (2, 3): 36 M doubles of blocks in registers forbid M = 3, so M = 2
// (the 9 rows in 5 groups, the last holding one row), 255 threads, 246
// registers; then (1, 2), a thread per (node, lane) and two lanes a slab,
// for the levels the first does not fit. A level runs here when one of
// its dtype's geometries fits a block (threads within the instance's
// bound; the stencils, e and the buffer in 227 KB of shared memory): the
// 9x17 and the wrapped 9x16 levels take the first; 17x33 fits none and
// runs per sweep through the S = 3 kernel. No level of the repo's paths
// takes (1, 2): it is there so that a level the one-node design fused and
// the first geometry does not fit (10x16 in f32, 5x32 in f64) stays
// fused, and it is slower than that design was (at 9x17, where it does
// not run, 0.1686 / 0.3068 ms against 0.1607 / 0.2983). With one block an SM the slabs
// take 5 rounds in f32 (586 slabs of 7 lanes over 132 blocks) and 11 in
// f64 (1,366 of 3).
//
// Measured at 4,096 lanes on NVIDIA H100 80GB HBM3, 700 W, in interleaved
// rounds against the one-node design it replaced (chip_smoke.py phase 17
// with --baseline; scripts/ell_coarse_variants.py as of commit b558abc;
// PERF.md §6): 9x17 f32
// 0.1298-0.1312 ms (was 0.1587-0.1607; 27% of the bound), f64
// 0.2687-0.2694 (was 0.2966-0.2983; 26%); wrapped 9x16 f32 0.1276-0.1284
// (was 0.1370-0.1378), f64 0.2609-0.2621 (0.2604-0.2617: no gain). Tried
// and slower: f32 (3, 4) in 256-thread blocks (198 registers) 0.1323 at
// 9x17 (0.1275 at 9x16, within the rounds' spread of the first); f64
// (2, 2) in 192 (240 registers) 0.3435 / 0.3068; stencils read through L1
// instead of staged (several blocks an SM, (2, 2) and (3, 2)); a guard per
// neighbour row, which kept the loads of a sweep from being issued
// together.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "per_device.cuh"

namespace {

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
// four consecutive values (16-byte aligned)
__device__ __forceinline__ void ld4(const float* p, float (&q)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&q)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  q[0] = a.x;
  q[1] = a.y;
  q[2] = b.x;
  q[3] = b.y;
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

template <typename T, int M, int L, int kCap>
__global__ void __launch_bounds__(kCap) lane_coarse_smooth3_kernel(
    const T* __restrict__ packed, const T* __restrict__ dinv, const T* __restrict__ wa,
    const T* __restrict__ wb, const T* __restrict__ wc, const T* __restrict__ r,
    T* __restrict__ e_out, int rows, int cols, int64_t nb, int sweeps, T omega, bool wrap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nodes = rows * cols;
  constexpr int kStride = Stage<T>::kStride;
  T* st = reinterpret_cast<T*>(smem_raw);  // the stencils, [nodes][kStride]
  T* buf = st + nodes * kStride;           // e, double-buffered
  {
    constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
    const int n16 = nodes * (144 / kPer16);
    for (int k = threadIdx.x; k < n16; k += blockDim.x) {
      const int node = k / (144 / kPer16), part = k % (144 / kPer16);
      cp_async16(st + node * kStride + part * kPer16, packed + node * 144 + part * kPer16);
    }
  }
  const int cp = cols + 2;
  const int per_buf = (rows + M + 1) * cp * L * 2;
  T* pf = buf + 2 * per_buf;  // [6 M][blockDim]: a slab's dinv and r, brought ahead
  for (int k = threadIdx.x; k < 2 * per_buf; k += blockDim.x) buf[k] = T(0);
  const int sl = threadIdx.x % L;
  const int pos = threadIdx.x / L;
  const bool placed = pos < ((rows + M - 1) / M) * cols;
  const int c = pos % cols;
  const int r0 = (pos / cols) * M;  // the thread's first row
  // nodes of the thread inside the grid (0 for a thread past the level)
  const int held = placed ? min(M, rows - r0) : 0;
  int colp[3];
  if (wrap) {
    colp[0] = (c == 0 ? cols - 1 : c - 1) + 1;
    colp[2] = (c == cols - 1 ? 0 : c + 1) + 1;
  } else {
    colp[0] = c;
    colp[2] = c + 2;
  }
  colp[1] = c + 1;
  // e of node i at padded row r0 + i + 1, padded column c + 1
  const int self = (((r0 + 1) * cp + colp[1]) * L + sl) * 2;
  const int row_step = cp * L * 2;
  const int64_t plane = static_cast<int64_t>(nodes) * nb;
  const int64_t slabs = (nb + L - 1) / L;
  auto prefetch = [&](int64_t slab) {
    const int64_t lane = slab * L + sl;
    if (lane >= nb) return;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < held) {
        const int64_t at = static_cast<int64_t>((r0 + i) * cols + c) * nb + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async_small<sizeof(T)>(pf + (6 * i + q) * blockDim.x + threadIdx.x,
                                    dinv + q * plane + at);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          cp_async_small<sizeof(T)>(pf + (6 * i + 4 + q) * blockDim.x + threadIdx.x,
                                    r + q * plane + at);
      }
    }
  };
  prefetch(blockIdx.x);
  cp_async_commit();
  for (int64_t slab = blockIdx.x; slab < slabs; slab += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // the stencils (first slab), this slab's dinv and r
    const int64_t lane = slab * L + sl;
    const int act = lane < nb ? held : 0;  // the thread's nodes this slab
    T coef[M][9][2][2];
    T di[M][2][2];
    T rr[M][2];
    {
      T w0 = T(0), w1 = T(0), w2 = T(0);
      if (act > 0) {
        w0 = __ldg(wa + lane);
        w1 = __ldg(wb + lane);
        w2 = __ldg(wc + lane);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const bool on = i < act;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          di[i][q / 2][q % 2] = on ? pf[(6 * i + q) * blockDim.x + threadIdx.x] : T(0);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          rr[i][q] = on ? pf[(6 * i + 4 + q) * blockDim.x + threadIdx.x] : T(0);
        const T* cb = st + (on ? (r0 + i) * cols + c : 0) * kStride;
#pragma unroll
        for (int s = 0; s < 9; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            T v[4];
            ld4(cb + (s * 4 + q) * 4, v);
            coef[i][s][q / 2][q % 2] = on ? v[0] * w0 + v[1] * w1 + v[2] * w2 + v[3] : T(0);
          }
      }
    }
    __syncthreads();  // every thread has its dinv and r: the buffer takes the next slab's
    if (slab + gridDim.x < slabs) prefetch(slab + gridDim.x);
    cp_async_commit();
    T e[M][2];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      e[i][0] = omega * (di[i][0][0] * rr[i][0] + di[i][0][1] * rr[i][1]);
      e[i][1] = omega * (di[i][1][0] * rr[i][0] + di[i][1][1] * rr[i][1]);
      if (i < act) st2(buf + self + i * row_step, e[i][0], e[i][1]);
    }
    __syncthreads();
    for (int k = 1; k < sweeps; ++k) {
      const T* cur = buf + ((k - 1) & 1) * per_buf;
      T* nxt = buf + (k & 1) * per_buf;
      if (act > 0) {
        T y[M][2];
#pragma unroll
        for (int i = 0; i < M; ++i) y[i][0] = y[i][1] = T(0);
        // padded rows r0 .. r0 + M + 1 (zero below the grid: the buffer
        // has M - 1 spare rows, so a thread holding fewer than M rows reads
        // no guard); node i reads rows i .. i + 2 of them, its stencil's
        // offsets (row - i) * 3 + column in order
#pragma unroll
        for (int q = 0; q < M + 2; ++q) {
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            T x0, x1;
            ld2(cur + (((r0 + q) * cp + colp[dc]) * L + sl) * 2, x0, x1);
#pragma unroll
            for (int i = 0; i < M; ++i) {
              if (q - i >= 0 && q - i <= 2) {
                const int s = (q - i) * 3 + dc;
                y[i][0] = y[i][0] + coef[i][s][0][0] * x0 + coef[i][s][0][1] * x1;
                y[i][1] = y[i][1] + coef[i][s][1][0] * x0 + coef[i][s][1][1] * x1;
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T res0 = rr[i][0] - y[i][0], res1 = rr[i][1] - y[i][1];
          e[i][0] = e[i][0] + omega * (di[i][0][0] * res0 + di[i][0][1] * res1);
          e[i][1] = e[i][1] + omega * (di[i][1][0] * res0 + di[i][1][1] * res1);
          if (i < act) st2(nxt + self + i * row_step, e[i][0], e[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < act) {
        const int64_t at = static_cast<int64_t>((r0 + i) * cols + c) * nb + lane;
        e_out[at] = e[i][0];
        e_out[plane + at] = e[i][1];
      }
    }
  }
}

// The stencils, e's two buffers (M - 1 spare zero rows below the border)
// and the dinv / r buffer.
template <typename T>
size_t smem_bytes(int rows, int cols, int m, int lanes, int threads) {
  return (static_cast<size_t>(rows) * cols * Stage<T>::kStride +
          static_cast<size_t>(2) * (rows + m + 1) * (cols + 2) * lanes * 2 +
          static_cast<size_t>(6) * m * threads) * sizeof(T);
}

// The block of a geometry: ceil(rows / m) * cols * lanes threads, rounded
// up to a warp; 0 where the level does not fit (more threads than `cap`,
// or shared memory past 227 KB).
template <typename T>
int fit(int rows, int cols, int m, int lanes, int cap) {
  if (rows < 1 || cols < 2) return 0;
  const int threads = ((rows + m - 1) / m * cols * lanes + 31) / 32 * 32;
  if (threads > cap || smem_bytes<T>(rows, cols, m, lanes, threads) > kMaxSmem) return 0;
  return threads;
}

template <typename T, int M, int L, int kCap>
int launch(const void* packed, const void* dinv, const void* wa, const void* wb, const void* wc,
           const void* r, void* e, int rows, int cols, int64_t nb, int sweeps, double omega,
           int wrap, cudaStream_t stream) {
  const int threads = fit<T>(rows, cols, M, L, kCap);
  if (threads == 0 || nb < 1 || sweeps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(rows, cols, M, L, threads);
  auto kernel = lane_coarse_smooth3_kernel<T, M, L, kCap>;
  // once per instance and device; the occupancy query below reads the
  // allowance of the current device
  static std::atomic<bool> allowed[mt::kMaxDevices];
  const cudaError_t err = mt::once_per_device(allowed, [kernel] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = mt::sm_count();
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int64_t slabs = (nb + L - 1) / L;
  // persistent blocks: as many as fit on the card at once
  const int64_t blocks =
      std::min<int64_t>(slabs, static_cast<int64_t>(std::max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(packed), static_cast<const T*>(dinv), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(wc), static_cast<const T*>(r),
      static_cast<T*>(e), rows, cols, nb, sweeps, static_cast<T>(omega), wrap != 0);
  return static_cast<int>(cudaGetLastError());
}

// The geometries of each value type, in the order a level takes them (the
// first that fits): (M rows a thread, L lanes a slab, the block bound).
// kernels/lane_coarse_kernel.py's GEOMETRIES mirrors these lists.
#define MT_COARSE_F32(X) X(3, 7, 384) X(1, 2, 320)
#define MT_COARSE_F64(X) X(2, 3, 256) X(1, 2, 320)

// The first of the value type's geometries the level fits.
template <typename T>
int run(const void* packed, const void* dinv, const void* wa, const void* wb, const void* wc,
        const void* r, void* e, int rows, int cols, int64_t nb, int sweeps, double omega,
        int wrap, cudaStream_t s) {
#define MT_COARSE_RUN(M, L, CAP)                                                        \
  if (fit<T>(rows, cols, M, L, CAP) > 0) {                                              \
    return launch<T, M, L, CAP>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, \
                                omega, wrap, s);                                        \
  }
  if constexpr (sizeof(T) == 4) {
    MT_COARSE_F32(MT_COARSE_RUN)
  } else {
    MT_COARSE_F64(MT_COARSE_RUN)
  }
#undef MT_COARSE_RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = float64. packed [R, C, 9, 2, 2, 4] (16-byte
// aligned), dinv [2, 2, R, C, B], wa / wb / wc [B], r and e [2, R, C, B];
// the level must fit one of the dtype's geometries (lane_coarse_plan).
// Returns a cudaError_t code (0 = launched).
extern "C" int mt_lane_coarse_smooth3(int dtype, int wrap, const void* packed, const void* dinv,
                                      const void* wa, const void* wb, const void* wc,
                                      const void* r, void* e, int rows, int cols, int64_t nb,
                                      int sweeps, double omega, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run<float>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, omega, wrap, s);
  }
  if (dtype == 1) {
    return run<double>(packed, dinv, wa, wb, wc, r, e, rows, cols, nb, sweeps, omega, wrap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
