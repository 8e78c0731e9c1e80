// A tensor-core variant of the f64 S = 3 lane stencil matvec, measured
// against the committed FMA instance by scripts/lane_stencil_variants.py
// and not used by the port (PERF.md §6, PR 11: it ran slower).
//
// It includes the committed kernel source for its lane geometry, its
// shared-memory ring of u rows and its staged coefficient rows, and
// replaces only the arithmetic: per node and 8 lanes, Z [8 x 8] = A [8 x
// 20] . U [20 x 8] in five mma.sync m8n8k4 f64 steps, A's rows (basis m,
// output i) = m * 2 + i, its columns (offset s, input j) = s * 2 + j (18,
// padded to 20), U the 18 neighbour values of the 8 lanes; then y_i =
// sum_m w_m Z[m * 2 + i] (w_fix = 1) by two warp shuffles. A warp computes
// two columns at once (two accumulator pairs).

#include "../magnetite_tpu_torch/csrc/lane_stencil_matvec.cu"

namespace {

__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

constexpr int kDmmaThreads = 256;  // 8 warps: 4 lane groups x 2 column streams

__global__ void __launch_bounds__(kDmmaThreads) lane_stencil3_dmma_kernel(
    const double* __restrict__ packed, const double* __restrict__ wa,
    const double* __restrict__ wb, const double* __restrict__ wc, const double* __restrict__ u,
    double* __restrict__ y, int rows, int cols, int64_t nb, int tile_cols, int strip_rows,
    bool vec, bool wrap) {
  using L = Lanes<double>;
  using K = Coefs<double, 3>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  const int tcols = tile_cols + 2;
  const int slot_len = 2 * tcols * L::kSlab;
  double* coef_ring = ring + kRing * slot_len;
  const int coef_len = tile_cols * K::kStride;
  const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * L::kSlab;
  const int c0 = static_cast<int>(blockIdx.y) * tile_cols;
  const int ncols = min(tile_cols, cols - c0);
  const int r0 = static_cast<int>(blockIdx.z) * strip_rows;
  const int r1 = min(rows, r0 + strip_rows);
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const int g = lid >> 2, t = lid & 3;  // fragment row / column group
  const int m = g >> 1, i = g & 1;
  const int q = warp & 3;  // the warp's 8 lanes of the slab
  const int streams = (blockDim.x >> 5) >> 2;
  double wv[2];
  {
    const double* ws[3] = {wa, wb, wc};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t lane = lane0 + q * 8 + 2 * t + h;
      wv[h] = m == 3 ? 1.0 : (lane < nb ? __ldg(ws[m] + lane) : 0.0);
    }
  }
  auto slot = [&](int row) { return ring + ((row - r0 + 1) & (kRing - 1)) * slot_len; };
  auto cslot = [&](int row) { return coef_ring + ((row - r0) & 1) * coef_len; };
  for (int row = r0 - 1; row <= r0 + 1; ++row)
    fill_row<double>(slot(row), u, row, rows, cols, c0, tcols, nb, lane0, vec, wrap);
  fill_coefs<double, 3>(cslot(r0), packed, r0, cols, c0, ncols);
  cp_async_commit();
  for (int r = r0; r < r1; ++r) {
    if (r + 2 <= r1) {
      fill_row<double>(slot(r + 2), u, r + 2, rows, cols, c0, tcols, nb, lane0, vec, wrap);
    }
    if (r + 1 < r1) fill_coefs<double, 3>(cslot(r + 1), packed, r + 1, cols, c0, ncols);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int tc = warp >> 2; tc < ncols; tc += 2 * streams) {
      const int tc2 = tc + streams;
      const bool two = tc2 < ncols;
      const int tcb = two ? tc2 : tc;
      const double* cb = cslot(r) + tc * K::kStride;
      const double* cb2 = cslot(r) + tcb * K::kStride;
      double d0 = 0.0, d1 = 0.0, e0 = 0.0, e1 = 0.0;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int idx = k * 4 + t;  // (s, j) = (idx / 2, idx % 2); 18, 19 pad
        const int sidx = idx >> 1, j = idx & 1;
        double a = 0.0, b = 0.0, a2 = 0.0, b2 = 0.0;
        if (idx < 18) {
          const int at = (sidx * 4 + i * 2 + j) * 4 + m;
          const double* row_s = slot(r - 1 + sidx / 3) + j * tcols * L::kSlab + q * 8 + g;
          a = cb[at];
          b = row_s[(tc + sidx % 3) * L::kSlab];
          a2 = cb2[at];
          b2 = row_s[(tcb + sidx % 3) * L::kSlab];
        }
        dmma(d0, d1, a, b);
        dmma(e0, e1, a2, b2);
      }
      for (int h = 0; h < (two ? 2 : 1); ++h) {
        double v0 = (h ? e0 : d0) * wv[0], v1 = (h ? e1 : d1) * wv[1];
        v0 += __shfl_xor_sync(0xffffffffu, v0, 8);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 8);
        v0 += __shfl_xor_sync(0xffffffffu, v0, 16);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 16);
        if (lid < 8) {  // m = 0: output i = g, lanes 2t, 2t + 1 of the group
          const int64_t node = static_cast<int64_t>(r) * cols + c0 + (h ? tc2 : tc);
          const int64_t lane = lane0 + q * 8 + 2 * t;
          double* dst = y + (i * plane + node) * nb + lane;
          if (vec && lane < nb) {
            *reinterpret_cast<double2*>(dst) = make_double2(v0, v1);
          } else {
            if (lane < nb) dst[0] = v0;
            if (lane + 1 < nb) dst[1] = v1;
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// f64 S = 3 through the tensor-core variant; arguments as
// mt_lane_stencil_matvec3's (dtype must be 1).
extern "C" int mt_lane_stencil_matvec3_dmma(int dtype, int wrap, int vec, const void* packed,
                                            const void* wa, const void* wb, const void* wc,
                                            const void* u, void* y, int rows, int cols,
                                            int64_t nb, int tile_cols, int strip_rows,
                                            void* stream) {
  using L = Lanes<double>;
  if (dtype != 1 || rows < 1 || cols < 2 || nb < 1 || tile_cols < 1 ||
      tile_cols > kMaxTileCols || strip_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      lane_stencil3_dmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((nb + L::kSlab - 1) / L::kSlab),
                  static_cast<unsigned>((cols + tile_cols - 1) / tile_cols),
                  static_cast<unsigned>((rows + strip_rows - 1) / strip_rows));
  const size_t smem = (static_cast<size_t>(kRing) * 2 * (tile_cols + 2) * L::kSlab +
                       2 * static_cast<size_t>(tile_cols) * Coefs<double, 3>::kStride) *
                      sizeof(double);
  lane_stencil3_dmma_kernel<<<grid, kDmmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(packed), static_cast<const double*>(wa),
      static_cast<const double*>(wb), static_cast<const double*>(wc),
      static_cast<const double*>(u), static_cast<double*>(y), rows, cols, nb, tile_cols,
      strip_rows, vec != 0, wrap != 0);
  return static_cast<int>(cudaGetLastError());
}
