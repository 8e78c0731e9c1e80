// Lane-batched 9-point 2x2-block stencil SpMV on Hopper (sm_90a), the
// operator of the structured-grid design sweeps:
//
//   S = 1  y[i, r, c, b] = sum_s sum_j S[s, i, j, r, c] * u[j, r + dr_s, c + dt_s, b]
//   S = 3  the same, the block of offset s per lane b being
//          wa[b] Sa[s] + wb[b] Sb[s] + wc[b] Sc[s] + Sfix[s]
//
// The stencils come packed node-major, once per compiled sweep
// (kernels/lane_stencil_kernel.py::pack_lane_stencils): S = 1 as [R, C, 9,
// 2, 2], S = 3 as [R, C, 9, 2, 2, 4] with (Sa, Sb, Sc, Sfix) innermost, so
// one 16-byte load gives the four basis values of one block entry in f32
// (two loads in f64). u / y are [2, R, C, B] lane fields (B minormost), the
// material weights [B] each. Rows outside the grid read zero; columns wrap
// (annulus meshes) or read zero outside the grid. f32 and f64 instances.
//
// No TPU kernel stands behind this one: the JAX package computes the same
// function in plain XLA (magnetite_tpu/parallel/sweep.py::
// _lane_stencil_matvec for S = 1, ::_lane_material_matvec for S = 3),
// which fuses the pad, the nine slices and the FMA chain into one pass. In
// eager PyTorch that chain is ~40 (S = 1) or ~150 (S = 3) launches per
// matvec, and a sweep's V-cycles make hundreds of matvecs per solve.
//
// What bounds it: device memory, and for S = 3 the FMAs about as much. At
// the bench grid (33 x 65 nodes, B = 4,096) u and y are 70 MB each in f32;
// S = 1 does 8 flops per stencil term and lane, S = 3 32 (24 to combine the
// lane's block entry from the four bases, 8 to apply it): in f32 S = 3's
// flops take 0.038 ms of 67 TFLOP/s against 0.042 ms of bytes, in f64 0.074
// ms of 34 TFLOP/s against 0.085 ms.
//
// Design. A block owns a lane slab (64 f32 / 32 f64 lanes), a tile of at
// most 16 columns and a strip of rows, and walks the strip down the rows.
// Two things pass through shared memory, filled by cp.async one row ahead
// of the row computed: a ring of 4 u rows (the tile's columns plus one halo
// column each side, both components, the slab's lanes), so each u element
// crosses from L2 once per block (the strip's two halo rows aside), and
// two rows of the tile's packed coefficients (contiguous in the packed
// array; a node's 36 or 144 values padded by 16 bytes, so the four columns
// a warp reads fall in different banks). Eight threads share a column; each
// carries two 16-byte chunks of lanes (8 f32 / 4 f64), chunks lv and lv + 8
// of the slab, so a quarter warp reads 128 contiguous bytes of a ring row
// (no bank conflicts) and writes 128 contiguous bytes of y. The registers
// PR 9's design spent on a 3 x 3 window of u (24 vectors with its
// load-ahead row) carry the lanes instead: one coefficient load feeds 32
// FMAs in f32 (S = 1 a float4 of four block entries x 8 lanes; S = 3 a
// float4 of four bases x 8 lanes) and 8-16 in f64. S = 3 combines each
// block entry from the four bases per lane first (three FMAs, as the plain
// version combines the coefficients), then applies it. Sums run over s =
// 0..8 in order, component 0 before 1, as the plain version's. Where B is
// not a multiple of the 16-byte chunk or a lane field is not 16-byte
// aligned, the ring is filled and y written one lane at a time (vec = 0);
// the packed stencils are always 16-byte aligned (the wrapper refuses them
// otherwise). The grid (lane_stencil_plan): tiles of at most 16 columns
// evened out (65: 5 of 13), strips of 6 rows (2 on grids of at most 12):
// small blocks, several per SM, many waves.
//
// ptxas (sm_90a): S = 1 53 / 58 registers (f32 / f64), S = 3 85 / 96, no
// spills; at the bench grid a block (13 columns, 104 threads) takes 35 KB
// (S = 1 f32) to 61 KB (S = 3 f64) of shared memory, so 3-6 blocks share an
// SM.
//
// Measured at the bench grid, 4,096 lanes, NVIDIA H100 80GB HBM3, 700 W
// (PERF.md §6 row 9): S = 1 0.066 ms f32 / 0.120 ms f64 (64% / 70% of the
// bound), S = 3 0.125 / 0.239 ms (34% / 35%); PR 9's register-window design
// ran 0.090 / 0.190 and 0.190 / 0.444 ms. Without the coefficient staging
// (coefficients through L1 / L2, 22-column tiles) S = 3 f64 ran 0.35 ms
// and S = 1 f64 0.18 ms. A tensor-core f64 S = 3 variant
// (scripts/lane_stencil3_dmma.cu, mma.sync m8n8k4) ran 0.355 ms. What
// holds S = 3 at a third of its bound is not identified: its FMA pipe runs
// ~30% busy, and the profilers that read stall reasons do not run on the
// card's machine.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "per_device.cuh"

namespace {

// Lane geometry per value type: a 16-byte chunk holds kChunk lanes, a
// thread carries two chunks of one column, kNV threads share a column.
template <typename T>
struct Lanes {
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));  // 4 f32, 2 f64
  static constexpr int kV = 2 * kChunk;                            // lanes per thread
  static constexpr int kNV = 8;                                    // threads per column
  static constexpr int kChunks = 2 * kNV;                          // chunks per slab
  static constexpr int kSlab = kChunks * kChunk;                   // 64 f32, 32 f64 lanes
};

constexpr int kRing = 4;  // u rows in shared memory: r - 1, r, r + 1 and the one in flight
constexpr int kMaxTileCols = 16;
constexpr int kMaxThreads = 8 * kMaxTileCols;
// the widest tile's ring (4 rows x 2 components x 18 columns x the slab's
// 256 bytes) and two coefficient rows of S = 3 in f64 (16 nodes x 146)
constexpr int kMaxSmem = kRing * 2 * (kMaxTileCols + 2) * 256 + 2 * kMaxTileCols * 146 * 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 16 bytes: four f32 or two f64 values.
__device__ __forceinline__ void ld16(const float* p, float* out) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double* out) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  out[0] = q.x; out[1] = q.y;
}
__device__ __forceinline__ void ldg16(const float* p, float* out) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}
__device__ __forceinline__ void ldg16(const double* p, double* out) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  out[0] = q.x; out[1] = q.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Fill ring slot `slot` with u row `row` over the tile's columns c0 - 1 ..
// c0 + tile_cols (wrapped or zero outside the grid), both components and
// the slab's lanes: [component][tile column][slab lane].
template <typename T>
__device__ __forceinline__ void fill_row(T* slot, const T* __restrict__ u, int row, int rows,
                                         int cols, int c0, int tcols, int64_t nb, int64_t lane0,
                                         bool vec, bool wrap) {
  using L = Lanes<T>;
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int n = 2 * tcols * L::kChunks;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int q = k % L::kChunks;
    const int rest = k / L::kChunks;
    const int t = rest % tcols;
    const int j = rest / tcols;
    T* dst = slot + (j * tcols + t) * L::kSlab + q * L::kChunk;
    int gc = c0 - 1 + t;
    bool ok = row >= 0 && row < rows;
    if (wrap) {
      gc = (gc % cols + cols) % cols;
    } else {
      ok = ok && gc >= 0 && gc < cols;
    }
    const int64_t lane = lane0 + q * L::kChunk;
    if (ok && vec && lane < nb) {  // vec: the whole chunk lies in [0, nb), 16-byte aligned
      cp_async16(dst, u + (j * plane + static_cast<int64_t>(row) * cols + gc) * nb + lane);
    } else if (ok) {
      const T* src = u + (j * plane + static_cast<int64_t>(row) * cols + gc) * nb + lane;
#pragma unroll
      for (int m = 0; m < L::kChunk; ++m) dst[m] = lane + m < nb ? src[m] : T(0);
    } else {
#pragma unroll
      for (int m = 0; m < L::kChunk; ++m) dst[m] = T(0);
    }
  }
}

// A node's coefficients in a shared-memory coefficient slot: its 36 block
// entries (x 4 bases for S = 3) and 16 bytes of padding, so the four
// columns a warp reads sit in different banks.
template <typename T, int S>
struct Coefs {
  static constexpr int kPerNode = 36 * (S == 3 ? 4 : 1);
  static constexpr int kStride = kPerNode + 16 / static_cast<int>(sizeof(T));
};

// Copy row `row`'s coefficients of the tile's columns (contiguous in the
// packed array) into a coefficient slot, 16 bytes per cp.async.
template <typename T, int S>
__device__ __forceinline__ void fill_coefs(T* slot, const T* __restrict__ packed, int row,
                                           int cols, int c0, int ncols) {
  using K = Coefs<T, S>;
  constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunksPerNode = K::kPerNode / kPer16;
  const T* src = packed + (static_cast<int64_t>(row) * cols + c0) * K::kPerNode;
  const int n = ncols * kChunksPerNode;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int node = k / kChunksPerNode, part = k % kChunksPerNode;
    cp_async16(slot + node * K::kStride + part * kPer16, src + node * K::kPerNode + part * kPer16);
  }
}

// The thread's kV lanes (chunks lv and lv + kNV) from a slab row at p.
template <typename T>
__device__ __forceinline__ void load_lanes(const T* p, int lv, T (&x)[Lanes<T>::kV]) {
  using L = Lanes<T>;
  ld16(p + lv * L::kChunk, x);
  ld16(p + (lv + L::kNV) * L::kChunk, x + L::kChunk);
}

template <typename T, int S>
__global__ void __launch_bounds__(kMaxThreads) lane_stencil_kernel(
    const T* __restrict__ packed, const T* __restrict__ wa, const T* __restrict__ wb,
    const T* __restrict__ wc, const T* __restrict__ u, T* __restrict__ y, int rows, int cols,
    int64_t nb, int tile_cols, int strip_rows, bool vec, bool wrap) {
  using L = Lanes<T>;
  constexpr int kV = L::kV;
  using K = Coefs<T, S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int tcols = tile_cols + 2;
  const int slot_len = 2 * tcols * L::kSlab;
  T* coef_ring = ring + kRing * slot_len;  // two coefficient slots
  const int coef_len = tile_cols * K::kStride;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * L::kSlab;
  const int c0 = static_cast<int>(blockIdx.y) * tile_cols;
  const int ncols = min(tile_cols, cols - c0);
  const int r0 = static_cast<int>(blockIdx.z) * strip_rows;
  const int r1 = min(rows, r0 + strip_rows);
  const int tc = threadIdx.x / L::kNV;
  const int lv = threadIdx.x % L::kNV;
  const int c = c0 + tc;
  const bool active = c < cols;
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  // the thread's two chunks of lanes
  const int64_t lanes[2] = {lane0 + lv * L::kChunk, lane0 + (lv + L::kNV) * L::kChunk};

  T w[3][kV];
  if constexpr (S == 3) {
    const T* ws[3] = {wa, wb, wc};
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (vec && lanes[h] < nb) {
          ldg16(ws[m] + lanes[h], w[m] + h * L::kChunk);
        } else {
#pragma unroll
          for (int k = 0; k < L::kChunk; ++k)
            w[m][h * L::kChunk + k] = lanes[h] + k < nb ? __ldg(ws[m] + lanes[h] + k) : T(0);
        }
      }
  }

  auto slot = [&](int row) { return ring + ((row - r0 + 1) & (kRing - 1)) * slot_len; };
  auto cslot = [&](int row) { return coef_ring + ((row - r0) & 1) * coef_len; };
  for (int row = r0 - 1; row <= r0 + 1; ++row)
    fill_row<T>(slot(row), u, row, rows, cols, c0, tcols, nb, lane0, vec, wrap);
  fill_coefs<T, S>(cslot(r0), packed, r0, cols, c0, ncols);
  cp_async_commit();

  for (int r = r0; r < r1; ++r) {
    // row r + 2 goes into the slot of row r - 2, free since the last barrier
    if (r + 2 <= r1) {
      fill_row<T>(slot(r + 2), u, r + 2, rows, cols, c0, tcols, nb, lane0, vec, wrap);
    }
    if (r + 1 < r1) fill_coefs<T, S>(cslot(r + 1), packed, r + 1, cols, c0, ncols);
    cp_async_commit();
    cp_async_wait<1>();  // every copy but row r + 2's has landed
    __syncthreads();
    if (active) {
      const int64_t node = static_cast<int64_t>(r) * cols + c;
      const T* cb = cslot(r) + tc * K::kStride;
      T acc[2][kV];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < kV; ++k) acc[i][k] = T(0);
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const T* row_s = slot(r - 1 + s / 3);
        const int t = tc + s % 3;  // tile column of c + dt
        T x[2][kV];
#pragma unroll
        for (int j = 0; j < 2; ++j) load_lanes<T>(row_s + (j * tcols + t) * L::kSlab, lv, x[j]);
        if constexpr (S == 1) {
          T blk[4];
          ld16(cb + s * 4, blk);
          if constexpr (sizeof(T) == 8) ld16(cb + s * 4 + 2, blk + 2);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int k = 0; k < kV; ++k) acc[i][k] += blk[i * 2 + j] * x[j][k];
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              T b4[4];  // Sa, Sb, Sc, Sfix of entry (i, j)
              ld16(cb + (s * 4 + i * 2 + j) * 4, b4);
              if constexpr (sizeof(T) == 8) ld16(cb + (s * 4 + i * 2 + j) * 4 + 2, b4 + 2);
#pragma unroll
              for (int k = 0; k < kV; ++k) {
                const T coef = fma(b4[0], w[0][k], fma(b4[1], w[1][k], fma(b4[2], w[2][k], b4[3])));
                acc[i][k] += coef * x[j][k];
              }
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          T* dst = y + (i * plane + node) * nb + lanes[h];
          const T* v = acc[i] + h * L::kChunk;
          if (vec && lanes[h] < nb) {
            st16(dst, v);
          } else {
#pragma unroll
            for (int k = 0; k < L::kChunk; ++k)
              if (lanes[h] + k < nb) dst[k] = v[k];
          }
        }
    }
    __syncthreads();  // row r - 1's slot is refilled next step
  }
}

template <typename T, int S>
int launch(const void* packed, const void* wa, const void* wb, const void* wc, const void* u,
           void* y, int rows, int cols, int64_t nb, int tile_cols, int strip_rows, int vec,
           int wrap, cudaStream_t stream) {
  using L = Lanes<T>;
  if (rows < 1 || cols < 2 || nb < 1 || tile_cols < 1 || tile_cols > kMaxTileCols ||
      strip_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per instance and device
  static std::atomic<bool> allowed[mt::kMaxDevices];
  const cudaError_t err = mt::once_per_device(allowed, [] {
    return cudaFuncSetAttribute(lane_stencil_kernel<T, S>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nb + L::kSlab - 1) / L::kSlab),
                  static_cast<unsigned>((cols + tile_cols - 1) / tile_cols),
                  static_cast<unsigned>((rows + strip_rows - 1) / strip_rows));
  const size_t smem = (static_cast<size_t>(kRing) * 2 * (tile_cols + 2) * L::kSlab +
                       2 * static_cast<size_t>(tile_cols) * Coefs<T, S>::kStride) * sizeof(T);
  lane_stencil_kernel<T, S><<<grid, L::kNV * tile_cols, smem, stream>>>(
      static_cast<const T*>(packed), static_cast<const T*>(wa), static_cast<const T*>(wb),
      static_cast<const T*>(wc), static_cast<const T*>(u), static_cast<T*>(y), rows, cols, nb,
      tile_cols, strip_rows, vec != 0, wrap != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S = 1. dtype: 0 = float32, 1 = float64; packed [R, C, 9, 2, 2]; vec: 1
// when B is a multiple of the 16-byte chunk and u / y are 16-byte aligned;
// tile_cols (<= 32) and strip_rows from lane_stencil_plan. Returns a
// cudaError_t code (0 = launched).
extern "C" int mt_lane_stencil_matvec(int dtype, int wrap, int vec, const void* packed,
                                      const void* u, void* y, int rows, int cols, int64_t nb,
                                      int tile_cols, int strip_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, 1>(packed, nullptr, nullptr, nullptr, u, y, rows, cols, nb, tile_cols,
                            strip_rows, vec, wrap, s);
  }
  if (dtype == 1) {
    return launch<double, 1>(packed, nullptr, nullptr, nullptr, u, y, rows, cols, nb, tile_cols,
                             strip_rows, vec, wrap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// S = 3: packed [R, C, 9, 2, 2, 4] (Sa, Sb, Sc, Sfix innermost) and the
// per-lane weights wa, wb, wc [B]; vec also asks the weights to be 16-byte
// aligned; the rest as mt_lane_stencil_matvec.
extern "C" int mt_lane_stencil_matvec3(int dtype, int wrap, int vec, const void* packed,
                                       const void* wa, const void* wb, const void* wc,
                                       const void* u, void* y, int rows, int cols, int64_t nb,
                                       int tile_cols, int strip_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, 3>(packed, wa, wb, wc, u, y, rows, cols, nb, tile_cols, strip_rows, vec,
                            wrap, s);
  }
  if (dtype == 1) {
    return launch<double, 3>(packed, wa, wb, wc, u, y, rows, cols, nb, tile_cols, strip_rows, vec,
                             wrap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
