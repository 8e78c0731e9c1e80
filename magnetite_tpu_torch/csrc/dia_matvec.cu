// Banded block SpMV on Hopper (sm_90a):
//
//     y[i, n] = sum_d sum_j B_d[i, j, n] * u[j, n + off_d],   0 <= n + off_d < N
//
// bands [D, M, M, N] (N minormost), u / y [M, N]; M = 2 for the node-DOF
// stiffness operator, M = 3 for the banded coarse AMG levels.
//
// Replaces magnetite_tpu/pallas/dia_kernel.py::_kernel (launched by
// _dia_matvec_tiled, built by make_pallas_dia_operator). The TPU kernel
// pre-tiles the bands into VMEM-sized [G, D, m, m, tr, 512] chunks and streams
// u through a resident window; none of that is needed here.
//
// What bounds it: device-memory bandwidth. Every call streams all
// D * M * M * N band values once (41 bands x 2x2 x 500k nodes in f64 is
// ~656 MB at level 0; 25 bands x 3x3 x 48,553 nodes is 87 MB at the 1M
// plate's first coarse level) and does 2 flops per value, far below the
// card's flop/byte line. Two designs, one per block size:
//
// M = 2 (level 0): one thread per node n, so the 32 threads of a warp read
// 32 consecutive band values of every (d, i, j) plane -- fully coalesced.
// The u reads at n + off_d touch a window of about sqrt(N) nodes around the
// block's rows, which stays in L2 across the D bands. The offsets are loaded
// once per block into shared memory. Out-of-range columns are skipped by an
// explicit bounds check: a thread must never read outside [0, N). 500k
// threads fill the card many times over, so one offset's loads in flight
// per warp suffice (81% of the bound, PERF.md); the M = 3 design below,
// run at level 0, did not read within 2% of this one in both value types
// in one call (PERF.md), so the two stay apart.
//
// M = 3 (coarse levels: thousands to tens of thousands of nodes, 20-40
// offsets): one thread per node left 190 blocks on 132 SMs at N = 48,553,
// each thread walking all D offsets one after the other -- latency-bound
// at 42% of the bound. Here a block owns 32 consecutive nodes and its W
// warps split the offsets: warp w takes d = w, w + W, ... . Every warp load
// is still 32 consecutive values of one plane. The source lists the loads
// of U offsets (9 band planes and 3 u values each) before their FMAs, with
// predicated loads in place of the bounds check; how many stay in flight
// is ptxas's choice. For the U = 4 instance it picks 64 registers in f32,
// room for all 48 values, and 40 in f64, too few for the 48 doubles (96
// registers), so in f64 loads and FMAs interleave. It picks the same
// whether the launch bound allows 64 registers (1,024 threads) or 255
// (256), and the two builds time the same (PERF.md). W and U come from D
// and N in the C entry: at the first coarse level (1,518 blocks) 7 warps
// of U = 4 offsets, short blocks of which many stay resident; at the
// second (167 blocks) up to 32 warps of U = 1, so that every SM gets work.
// The W partial sums of a node meet in shared memory and are added in warp
// order: no atomics, so a call repeats bit for bit; only the summation
// order differs from the plain version. At the first coarse level the
// card's fixed cost per call (~7 us on an H100 with the timer of
// chip_smoke.py) is most of the gap to the bound in f64 and about half of
// it in f32 (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) dia_matvec_kernel(
    const T* __restrict__ bands, const int* __restrict__ offsets, int n_diags,
    const T* __restrict__ u, T* __restrict__ y, int64_t n) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < n_diags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= n) return;

  T acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = T(0);

  const int64_t plane = n;                    // stride between (i, j) planes
  const int64_t band_stride = int64_t(M) * M * n;
  const T* b = bands + row;
  for (int d = 0; d < n_diags; ++d, b += band_stride) {
    const int64_t col = row + s_off[d];
    if (col < 0 || col >= n) continue;
    T uc[M];
#pragma unroll
    for (int j = 0; j < M; ++j) uc[j] = __ldg(u + j * plane + col);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) acc[i] += __ldg(b + (i * M + j) * plane) * uc[j];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) y[i * plane + row] = acc[i];
}

// warps per block, at most, of the two instances (launch_slices)
constexpr int kWideWarps = 8, kNarrowWarps = 32;

// U: offsets whose loads one warp issues together; W: warps per block, at
// most. The launch bound follows W, so that the U = 4 instance (8 warps) may
// hold its 4 offsets' band and u values in registers.
template <typename T, int M, int U, int W>
__global__ void __launch_bounds__(W * 32) dia_matvec_slices_kernel(
    const T* __restrict__ bands, const int* __restrict__ offsets, int n_diags,
    const T* __restrict__ u, T* __restrict__ y, int64_t n) {
  __shared__ T part[W][M][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const int64_t plane = n;
  const int64_t band_stride = int64_t(M) * M * n;

  T acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = T(0);
  for (int d0 = warp; d0 < n_diags; d0 += U * warps) {
    T b[U][M * M], x[U][M];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int d = d0 + k * warps < n_diags ? d0 + k * warps : 0;
      const int64_t col = row + __ldg(offsets + d);
      const bool ok = d0 + k * warps < n_diags && row < n && col >= 0 && col < n;
      const T* bp = bands + d * band_stride + row;
#pragma unroll
      for (int e = 0; e < M * M; ++e) b[k][e] = ok ? __ldg(bp + e * plane) : T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) x[k][j] = ok ? __ldg(u + j * plane + col) : T(0);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int j = 0; j < M; ++j) acc[i] += b[k][i * M + j] * x[k][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  if (row >= n) return;
  for (int i = warp; i < M; i += warps) {
    T s = part[0][i][lane];
    for (int w = 1; w < warps; ++w) s += part[w][i][lane];
    y[i * plane + row] = s;
  }
}

template <typename T, int M>
int launch(const void* bands, const void* offsets, int n_diags, const void* u,
           void* y, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  dia_matvec_kernel<T, M><<<static_cast<unsigned>(blocks), kThreads,
                             n_diags * sizeof(int), stream>>>(
      static_cast<const T*>(bands), static_cast<const int*>(offsets), n_diags,
      static_cast<const T*>(u), static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Warps per block and offsets per batch from (D, N). Where the node groups
// give every SM at least four blocks (the 1M plate's first coarse level:
// 1,518 blocks), the offsets spread evenly over at most 8 warps, each
// issuing 4 offsets' loads at once -- D = 25: 7 warps of one batch --:
// short blocks of which many stay resident. Below that (its second level:
// 167 blocks) they spread over up to 32 warps that take one offset at a
// time -- D = 37: 19 warps of two --, so that the few blocks keep every SM
// busy and stay small enough in registers to be resident all at once.
template <typename T, int M>
int launch_slices(const void* bands, const void* offsets, int n_diags,
                  const void* u, void* y, int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + 31) / 32;
  const bool wide = blocks >= 4 * static_cast<int64_t>(sm_count());
  const int most = wide ? kWideWarps : kNarrowWarps;
  const int per_warp = (n_diags + most - 1) / most;
  const int warps = (n_diags + per_warp - 1) / per_warp;
  const dim3 grid(static_cast<unsigned>(blocks)), block(warps * 32);
  const T* b = static_cast<const T*>(bands);
  const int* o = static_cast<const int*>(offsets);
  const T* x = static_cast<const T*>(u);
  if (wide) {
    dia_matvec_slices_kernel<T, M, 4, kWideWarps><<<grid, block, 0, stream>>>(
        b, o, n_diags, x, static_cast<T*>(y), n);
  } else {
    dia_matvec_slices_kernel<T, M, 1, kNarrowWarps><<<grid, block, 0, stream>>>(
        b, o, n_diags, x, static_cast<T*>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t code (0 = launched).
extern "C" int mt_dia_matvec(int dtype, int m, const void* bands,
                             const void* offsets, int n_diags, const void* u,
                             void* y, int64_t n, void* stream) {
  if (n <= 0 || n_diags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && m == 2) return launch<float, 2>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 0 && m == 3) return launch_slices<float, 3>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 1 && m == 2) return launch<double, 2>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 1 && m == 3) return launch_slices<double, 3>(bands, offsets, n_diags, u, y, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
