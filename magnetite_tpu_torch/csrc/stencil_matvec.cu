// 9-point 2x2-block stencil SpMV on Hopper (sm_90a):
//
//     y[i, r, c] = sum_{dr,dt in -1..1} sum_j S[(dr+1)*3+dt+1, i, j, r, c] * u[j, r+dr, c+dt]
//
// S [9, 2, 2, R, C], u / y [2, R, C], cols minormost. Rows outside the grid
// contribute 0; columns wrap (WRAP, annulus meshes) or contribute 0 outside.
//
// Replaces both magnetite_tpu/pallas/stencil_kernel.py::_kernel (resident u,
// launched by _matvec_tiled) and ::_kernel_blocked (u streamed in row tiles
// with a halo, launched by _matvec_blocked). The TPU needed two variants and
// a pre-tiled band layout (pretile_stencil) only to fit u and one contiguous
// band DMA into VMEM; neither applies here, so one kernel serves every grid
// size and every multigrid level, in f32 and f64.
//
// What bounds it: device-memory bandwidth. Each call streams the 36 band
// planes once (36 x 8 B per node in f64: 151 MB at the 1M-element plate's
// 513 x 1024 grid) plus u and y (4 x 8 B per node), for 4 flops per band
// value. Design: one thread per grid node, consecutive threads along c, so
// each warp reads 32 consecutive values of every band plane (coalesced,
// read-only path). The nine u neighbours of a node lie within one row above
// and below; a block of 256 threads covers a quarter row of the 1M grid, so
// they are re-read from L1/L2 and DRAM sees u about once per call.
// Out-of-grid neighbours are skipped by explicit tests: a thread must never
// read outside u, whatever the band holds there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, bool WRAP>
__global__ void __launch_bounds__(kThreads) stencil_matvec_kernel(
    const T* __restrict__ st, const T* __restrict__ u, T* __restrict__ y,
    int rows, int cols) {
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int r = static_cast<int>(idx / cols);
  const int c = static_cast<int>(idx - static_cast<int64_t>(r) * cols);

  T acc0 = T(0), acc1 = T(0);
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
    const int rr = r + dr;
    if (rr < 0 || rr >= rows) continue;
#pragma unroll
    for (int dt = -1; dt <= 1; ++dt) {
      int cc = c + dt;
      if (WRAP) {
        cc = cc < 0 ? cc + cols : (cc >= cols ? cc - cols : cc);
      } else if (cc < 0 || cc >= cols) {
        continue;
      }
      const int s = (dr + 1) * 3 + (dt + 1);
      const int64_t nb = static_cast<int64_t>(rr) * cols + cc;
      const T u0 = __ldg(u + nb);
      const T u1 = __ldg(u + plane + nb);
      const T* b = st + static_cast<int64_t>(s) * 4 * plane + idx;
      acc0 += __ldg(b) * u0;
      acc0 += __ldg(b + plane) * u1;
      acc1 += __ldg(b + 2 * plane) * u0;
      acc1 += __ldg(b + 3 * plane) * u1;
    }
  }
  y[idx] = acc0;
  y[plane + idx] = acc1;
}

template <typename T, bool WRAP>
int launch(const void* st, const void* u, void* y, int rows, int cols,
           cudaStream_t stream) {
  const int64_t plane = static_cast<int64_t>(rows) * cols;
  const int64_t blocks = (plane + kThreads - 1) / kThreads;
  stencil_matvec_kernel<T, WRAP><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(st), static_cast<const T*>(u), static_cast<T*>(y),
      rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t code (0 = launched).
extern "C" int mt_stencil_matvec(int dtype, int wrap, const void* st,
                                 const void* u, void* y, int rows, int cols,
                                 void* stream) {
  if (rows <= 0 || cols < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wrap) return launch<float, true>(st, u, y, rows, cols, s);
  if (dtype == 0) return launch<float, false>(st, u, y, rows, cols, s);
  if (dtype == 1 && wrap) return launch<double, true>(st, u, y, rows, cols, s);
  if (dtype == 1) return launch<double, false>(st, u, y, rows, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
