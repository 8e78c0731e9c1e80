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
// ~656 MB) and does 2 flops per value, far below the card's flop/byte line.
// Design: one thread per node n, so the 32 threads of a warp read 32
// consecutive band values of every (d, i, j) plane -- fully coalesced. The
// u reads at n + off_d touch a window of about sqrt(N) nodes around the
// block's rows, which stays in L2 across the D bands. The offsets (at most
// ~80 ints) are loaded once per block into shared memory. Out-of-range
// columns are skipped by an explicit bounds check: the plain version's roll
// relies on those band entries being zero, but a thread must never read
// outside [0, N).

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

}  // namespace

// dtype: 0 = float32, 1 = float64. Returns a cudaError_t code (0 = launched).
extern "C" int mt_dia_matvec(int dtype, int m, const void* bands,
                             const void* offsets, int n_diags, const void* u,
                             void* y, int64_t n, void* stream) {
  if (n <= 0 || n_diags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && m == 2) return launch<float, 2>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 0 && m == 3) return launch<float, 3>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 1 && m == 2) return launch<double, 2>(bands, offsets, n_diags, u, y, n, s);
  if (dtype == 1 && m == 3) return launch<double, 3>(bands, offsets, n_diags, u, y, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* mt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
